"""Host waits for the card a frame inside the program's calls: torch.cuda's
sync-debug warnings raised inside the program's root spans
(obs/trace.py, traced run); layer: entry."""
from port_bench import program


def read(ctx):
    return program.host_syncs(ctx, "frame")
