"""The devices the port can render on.

The counterpart of the reference's OpenCL device dump (``PrintOpenCLInfo``,
``src/cpp/utility.cpp:3-61``), from ``torch.cuda``.  On a machine without
a card it reports none.
"""

from __future__ import annotations

import torch


def device_info() -> dict:
    """{"backend": "cuda" or "cpu", "device_count", "devices": [{"id",
    "name", "capability", "multiprocessors", "memory_bytes"}], and, with a
    card, "memory": {"bytes_free", "bytes_total"} of device 0}."""
    if not torch.cuda.is_available():
        return {"backend": "cpu", "device_count": 0, "devices": [],
                "torch": torch.__version__, "cuda": torch.version.cuda}
    devices = []
    for i in range(torch.cuda.device_count()):
        prop = torch.cuda.get_device_properties(i)
        devices.append({"id": i, "name": prop.name,
                        "capability": f"{prop.major}.{prop.minor}",
                        "multiprocessors": prop.multi_processor_count,
                        "memory_bytes": prop.total_memory})
    free, total = torch.cuda.mem_get_info(0)
    return {"backend": "cuda", "device_count": len(devices),
            "devices": devices, "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "memory": {"bytes_free": free, "bytes_total": total}}


def print_device_info() -> None:
    info = device_info()
    print(" === Device information ===")
    print(f"torch {info['torch']}, CUDA {info['cuda']}: "
          f"{info['device_count']} CUDA device(s)")
    for d in info["devices"]:
        print(f"  id {d['id']}: {d['name']} (compute capability "
              f"{d['capability']}, {d['multiprocessors']} SMs, "
              f"{d['memory_bytes'] / 2**30:.1f} GiB)")
    if "memory" in info:
        mem = info["memory"]
        print(f"Device 0 memory: "
              f"{(mem['bytes_total'] - mem['bytes_free']) / 2**30:.2f} / "
              f"{mem['bytes_total'] / 2**30:.2f} GiB in use")
    else:
        print("No CUDA device: only --cpu renders here")
    print(" === Done ===")
