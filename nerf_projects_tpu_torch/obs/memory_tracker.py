"""Device/host memory tracking with efficiency indices (port of
``nerf_projects_tpu/obs/memory_tracker.py``).

Parity target: reference plenoctree/memory_tracker.py (`MemorySnapshot`
:18, `MemoryTracker` :50-578): periodic snapshots of accelerator + process
+ system memory with peak tracking, and `calculate_efficiency_indices`
(:343-478) — memory_efficiency_index = PSNR/GB, quality_memory_tradeoff =
(PSNR*SSIM)/GB, lpips_memory_efficiency = (1-LPIPS)/GB, combined index,
storage_aware_mei = PSNR*log10(compression)/storage_GB, and
voxel_density_efficiency. The reference's nvidia-smi > reserved >
allocated > RSS source priority becomes: the card's allocator stats
(``torch.cuda.memory_stats``, every visible card summed) > process RSS;
on a host without a card the device fields read 0 and RSS is used.
"""
from __future__ import annotations

import gc
import os
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class MemorySnapshot:
    timestamp: str
    step: int
    device_bytes_in_use: float = 0.0
    device_bytes_limit: float = 0.0
    device_peak_bytes: float = 0.0
    process_rss_gb: float = 0.0
    system_used_gb: float = 0.0
    system_total_gb: float = 0.0

    @property
    def device_gb(self) -> float:
        return self.device_bytes_in_use / 1e9

    @property
    def device_peak_gb(self) -> float:
        return self.device_peak_bytes / 1e9


class MemoryTracker:
    def __init__(self):
        self.snapshots = []
        self.peak_device_bytes = 0.0
        self.peak_rss_gb = 0.0

    def _device_stats(self):
        try:
            import torch

            stats = {}
            if not torch.cuda.is_available():
                return stats
            for i in range(torch.cuda.device_count()):
                s = torch.cuda.memory_stats(i)
                stats["bytes_in_use"] = stats.get("bytes_in_use", 0) + s.get("allocated_bytes.all.current", 0)
                stats["peak_bytes_in_use"] = stats.get("peak_bytes_in_use", 0) + s.get("allocated_bytes.all.peak", 0)
                stats["bytes_limit"] = stats.get("bytes_limit", 0) + torch.cuda.get_device_properties(i).total_memory
            return stats
        except Exception:
            return {}

    def capture_snapshot(self, step: int = 0) -> MemorySnapshot:
        dev = self._device_stats()
        rss_gb = used = total = 0.0
        try:
            import psutil

            p = psutil.Process()
            rss_gb = p.memory_info().rss / 1e9
            vm = psutil.virtual_memory()
            used, total = vm.used / 1e9, vm.total / 1e9
        except Exception:  # no psutil: the process's resident pages
            try:
                with open("/proc/self/statm") as f:
                    rss_gb = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9
            except (OSError, ValueError):
                pass
        snap = MemorySnapshot(
            timestamp=datetime.now().isoformat(),
            step=step,
            device_bytes_in_use=float(dev.get("bytes_in_use", 0)),
            device_bytes_limit=float(dev.get("bytes_limit", 0)),
            device_peak_bytes=float(dev.get("peak_bytes_in_use", 0)),
            process_rss_gb=rss_gb,
            system_used_gb=used,
            system_total_gb=total,
        )
        self.peak_device_bytes = max(
            self.peak_device_bytes, snap.device_bytes_in_use, snap.device_peak_bytes
        )
        self.peak_rss_gb = max(self.peak_rss_gb, rss_gb)
        self.snapshots.append(snap)
        return snap

    def get_memory_metrics(self, snapshot: Optional[MemorySnapshot] = None) -> Dict[str, float]:
        snap = snapshot or (self.snapshots[-1] if self.snapshots else self.capture_snapshot())
        return {
            "device_memory_gb": snap.device_gb,
            "device_peak_memory_gb": self.peak_device_bytes / 1e9,
            "device_memory_limit_gb": snap.device_bytes_limit / 1e9,
            "process_rss_gb": snap.process_rss_gb,
            "peak_process_rss_gb": self.peak_rss_gb,
            "system_used_gb": snap.system_used_gb,
            "system_total_gb": snap.system_total_gb,
        }

    def _primary_memory_gb(self) -> float:
        """Source priority: device HBM > process RSS (tracker:408-423)."""
        if self.peak_device_bytes > 0:
            return self.peak_device_bytes / 1e9
        return max(self.peak_rss_gb, 1e-9)

    def calculate_efficiency_indices(
        self,
        psnr: float,
        ssim: Optional[float] = None,
        lpips: Optional[float] = None,
        *,
        storage_size_gb: Optional[float] = None,
        compression_ratio: Optional[float] = None,
        occupancy_ratio: Optional[float] = None,
    ) -> Dict[str, float]:
        primary = self._primary_memory_gb()
        peak = primary
        out: Dict[str, float] = {
            "memory_efficiency_index": psnr / primary,
            "peak_memory_efficiency_index": psnr / peak,
            "memory_source_gb": primary,
        }
        if ssim is not None:
            out["quality_memory_tradeoff"] = (psnr * ssim) / primary
        if lpips is not None:
            out["lpips_memory_efficiency"] = (1.0 - lpips) / primary
            out["peak_lpips_memory_efficiency"] = (1.0 - lpips) / peak
        if ssim is not None and lpips is not None:
            out["combined_quality_memory_index"] = (
                psnr * ssim * (1.0 - lpips)
            ) / primary
        if storage_size_gb and compression_ratio:
            out["storage_aware_mei"] = (
                psnr * np.log10(max(compression_ratio, 1.0 + 1e-9))
            ) / storage_size_gb
        if storage_size_gb and occupancy_ratio is not None:
            out["voxel_density_efficiency"] = (
                psnr * occupancy_ratio
            ) / storage_size_gb
        return out

    def get_model_size_estimate(self, params: Any = None) -> Dict[str, float]:
        """Parameter-count/bytes estimate (tracker:479-522 equivalent):
        ``params`` an nn.Module, a dict of tensors or an iterable of
        tensors."""
        if params is None:
            return {"param_count": 0, "param_gb": 0.0}
        if hasattr(params, "parameters"):
            leaves = list(params.parameters())
        elif isinstance(params, dict):
            leaves = list(params.values())
        else:
            leaves = list(params)
        count = sum(int(l.numel()) for l in leaves)
        nbytes = sum(int(l.numel()) * l.element_size() for l in leaves)
        return {"param_count": count, "param_gb": nbytes / 1e9}

    def cleanup_memory(self):
        gc.collect()

    def reset_peak_tracking(self):
        self.peak_device_bytes = 0.0
        self.peak_rss_gb = 0.0
