"""The frozen work arithmetic of each kernel's roofline against counts by
hand."""
import pytest

from port_bench.work import k1f, k2, k3, k4


def test_k1f_live_macs_by_layer():
    layers = [(63, 256)] + [(256, 256)] * 4 + [(256 + 63, 256)] + [(256, 256)] * 2 \
        + [(256, 1), (256, 256), (256 + 27, 128), (128, 3)]
    assert k1f.LIVE_MACS == sum(i * o for i, o in layers) == 593_408
    assert k1f.FLOPS_PER_ROW == 1_186_816  # the issue's 1.187 MFLOP a row


def test_k1f_work_at_the_render_chunks_levels():
    flops, nbytes = k1f.work(16384 * 64)
    assert flops == 2 * 593_408 * 1_048_576
    assert nbytes == 416 * 1_048_576 + k1f.WEIGHT_BYTES
    # operations bound it: 1.24 TFLOP at 989 TFLOP/s against 0.44 GB at 3.35 TB/s
    assert flops / 989e12 > 5 * nbytes / 3.35e12


def test_k2_is_three_forwards_a_row():
    flops, nbytes = k2.work(4096, 64, weights_out=True)
    rows = 4096 * 64
    assert flops == 3 * k1f.FLOPS_PER_ROW * rows
    assert nbytes == rows * 32 + 4096 * 32 + 3 * k1f.WEIGHT_BYTES + rows * 4
    assert k2.work(4096, 192, weights_out=False)[1] == 4096 * 192 * 32 + 4096 * 32 + 3 * k1f.WEIGHT_BYTES
    # a step of the paper's batch: 3.77 ms of the bf16 peak
    step = (k2.work(4096, 64, True)[0] + k2.work(4096, 192, False)[0]) / 989e12
    assert step == pytest.approx(3.7749e-3, rel=1e-4)


COUNTS = {"reach": 1000, "brick_steps": 50, "shaded": 200, "touched": 7, "marched": 1200, "dense": 210}


def test_k3_work_by_hand():
    B = 9
    flops, nbytes = k3.work(COUNTS, B, n_rays=512, n_tiles=4)
    shaded = 8 * 2 * 27 + 2 * 27 + 6 + 15  # 507
    assert k3.flops_per_shaded(B) == shaded
    assert flops == 1000 * 50 + 50 * 19 + 200 * shaded
    assert nbytes == 7 * 512 * 28 * 2 + 512 * 20 * 4 + 4 * 9 * 4


def test_k4_work_by_hand():
    B = 9
    flops, nbytes = k4.work(COUNTS, B, n_rays=512, n_tiles=4)
    bwd = 5 + 2 + 4 + 2 + 6 + 8 * (2 + 3 + 54)  # 491
    assert k4.bwd_flops_per_shaded(B) == bwd
    assert flops == 1000 * 50 + 50 * 19 + 200 * (507 + bwd)
    assert nbytes == 7 * 512 * 28 * 6 + 512 * 16 * 4 + 4 * 9 * 4
