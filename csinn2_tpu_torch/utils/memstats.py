"""Memory observability: live-tensor accounting and device memory stats
(counterpart of csinn2_tpu/utils/memstats.py).

The analog of the reference's debug allocator map (ref:
source/utils/memory.c:25-64 — shl_mem_map tracking total/leaked bytes,
guard-byte overwrite checks :75-85).  PyTorch owns the allocator, so:

  * live_buffer_report() — per device, the tensors Python can reach (a
    garbage-collector scan) and the bytes of their distinct storages; on a
    CUDA device also the caching allocator's own count of allocated bytes,
    which sees tensors held outside Python too;
  * total_live_bytes() — the live bytes of every device: the allocator's
    count on a CUDA device, the scan's on the CPU;
  * device_memory_stats() — torch.cuda.memory_stats of a CUDA device, with
    the JAX names bytes_in_use / peak_bytes_in_use / bytes_reserved added;
    None on the CPU, where the JAX function gives None as well;
  * MemoryWatermark — context manager asserting no net live-byte growth,
    the guard-byte "did anything escape" check for tests.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Dict, Optional

import torch


def _live_tensors():
    for obj in gc.get_objects():
        # type(), not isinstance(): the latter reads __class__, which some
        # module proxies answer with a warning
        if issubclass(type(obj), torch.Tensor) and obj.device.type != "meta":
            yield obj


def live_buffer_report() -> Dict[str, Dict[str, float]]:
    """{device: {count, bytes}} over the live tensors (bytes of distinct
    storages, so views count once); a CUDA device also has "allocated"."""
    per: Dict[str, Dict[str, float]] = {}
    seen = set()
    for t in _live_tensors():
        e = per.setdefault(str(t.device), {"count": 0, "bytes": 0})
        e["count"] += 1
        try:
            st = t.untyped_storage()
        except Exception:       # tensors without a storage (sparse, nested)
            continue
        key = (str(t.device), st.data_ptr())
        if key not in seen:
            seen.add(key)
            e["bytes"] += st.nbytes()
    for name, e in per.items():
        if name.startswith("cuda"):
            e["allocated"] = torch.cuda.memory_allocated(torch.device(name))
    return per


def total_live_bytes() -> int:
    return int(sum(e.get("allocated", e["bytes"]) for e in live_buffer_report().values()))


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """The CUDA caching allocator's counters of `device` (the current CUDA
    device by default); None on the CPU or without a card."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if device.type != "cuda":
        return None
    stats = dict(torch.cuda.memory_stats(device))
    stats.update(bytes_in_use=torch.cuda.memory_allocated(device),
                 peak_bytes_in_use=torch.cuda.max_memory_allocated(device),
                 bytes_reserved=torch.cuda.memory_reserved(device))
    return stats


@dataclasses.dataclass
class MemoryWatermark:
    """Assert no net live-byte growth across a region (leak check analog of
    the reference's shl_mem_map leak report)::

        with MemoryWatermark(tolerance_bytes=1 << 20):
            run_inference()
    """

    tolerance_bytes: int = 1 << 20
    _before: int = 0

    def __enter__(self):
        self._before = total_live_bytes()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        grown = total_live_bytes() - self._before
        if grown > self.tolerance_bytes:
            raise AssertionError(
                f"live tensors grew by {grown} bytes (> tolerance {self.tolerance_bytes})")
        return False
