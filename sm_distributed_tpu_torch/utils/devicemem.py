"""Device memory introspection, from ``torch.cuda``.

Port of ``sm_distributed_tpu/utils/devicemem.py``: the same roll-up keys,
read from PyTorch's caching allocator (``torch.cuda.memory_stats``,
``max_memory_allocated``) and the CUDA driver (``torch.cuda.mem_get_info``)
instead of PJRT's ``Device.memory_stats()``.  Without a CUDA device every byte field
is ``None``, as the reference gives on platforms without memory stats.

Import-light: it never initializes CUDA itself — a process that has not
touched the card has nothing to report (``torch.cuda.is_initialized()``).
"""

from __future__ import annotations

import torch

from .logger import logger


def device_stats() -> list[dict]:
    """One dict per visible CUDA device: ``{id, kind, platform,
    bytes_in_use, peak_bytes, limit_bytes}``.  ``bytes_in_use`` and
    ``peak_bytes`` are the caching allocator's allocated bytes (current and
    high-water mark since the last ``torch.cuda.reset_peak_memory_stats``),
    ``limit_bytes`` the device's total memory.  ``[]`` when the process has
    no initialized CUDA context."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            stats = torch.cuda.memory_stats(i)
            _free, total = torch.cuda.mem_get_info(i)
            out.append({
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "platform": "gpu",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                              0)),
                "peak_bytes": int(torch.cuda.max_memory_allocated(i)),
                "limit_bytes": int(total),
            })
        except RuntimeError as exc:
            logger.debug("devicemem: stats of cuda:%d unavailable (%s)", i,
                         exc)
    return out


def hbm_summary() -> dict:
    """Cross-device roll-up: ``{device_kind, device_count,
    hbm_bytes_in_use, hbm_peak_bytes, hbm_limit_bytes}``.  Byte fields are
    ``None`` when no device reports stats; in-use and limit sum across
    devices, the peak takes the max."""
    per = device_stats()
    in_use = [d["bytes_in_use"] for d in per if d["bytes_in_use"] is not None]
    peaks = [d["peak_bytes"] for d in per if d["peak_bytes"] is not None]
    limits = [d["limit_bytes"] for d in per if d["limit_bytes"] is not None]
    return {
        "device_kind": per[0]["kind"] if per else None,
        "device_count": len(per),
        "hbm_bytes_in_use": sum(in_use) if in_use else None,
        "hbm_peak_bytes": max(peaks) if peaks else None,
        "hbm_limit_bytes": sum(limits) if limits else None,
    }


def hbm_peak_bytes() -> int | None:
    """Max per-device peak, or ``None`` without device stats."""
    peaks = [d["peak_bytes"] for d in device_stats()
             if d["peak_bytes"] is not None]
    return max(peaks) if peaks else None
