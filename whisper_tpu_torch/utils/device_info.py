"""Accelerator device queries over torch.cuda.

Counterpart of whisper_tpu/utils/device_info.py: the reference's Vulkan
device-info surface (src/vulkan.rs:1-80: get_vulkan_device_count /
get_vulkan_device_description / get_vulkan_device_total_vram) and the
ggml backend-registry device scan (src/whisper.cpp:1320-1352). Here the
registry is the CUDA devices torch sees; with none, every query reports
no device (the CPU is not an accelerator).
"""

from __future__ import annotations

from typing import Dict, List

import torch


def device_count() -> int:
    """Number of visible CUDA devices (vulkan.rs get_vulkan_device_count)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _check(index: int) -> None:
    n = device_count()
    if not 0 <= index < n:
        raise IndexError(f"device index {index} out of range (0..{n - 1})")


def _description(index: int, props) -> str:
    return (f"cuda:{props.name} (id={index}, sm_{props.major}{props.minor}, "
            f"{props.multi_processor_count} SMs)")


def device_description(index: int = 0) -> str:
    """Human-readable device description (vulkan.rs get_vulkan_device_description)."""
    _check(index)
    return _description(index, torch.cuda.get_device_properties(index))


def device_total_memory(index: int = 0) -> int:
    """Total device memory in bytes (vulkan.rs get_vulkan_device_total_vram)."""
    _check(index)
    return int(torch.cuda.get_device_properties(index).total_memory)


def devices_info() -> List[Dict]:
    """One dict per device: the whisper.cpp startup device-scan log
    (src/whisper.cpp:1330-1346 "found device ...") as structured data."""
    out = []
    for i in range(device_count()):
        props = torch.cuda.get_device_properties(i)
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "index": i,
            "id": i,
            "platform": "gpu",
            "kind": props.name,
            "process_index": 0,
            "description": _description(i, props),
            "total_memory_bytes": int(total),
            "free_memory_bytes": int(free),
        })
    return out
