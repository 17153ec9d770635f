"""Device capability checks, counterpart of sfvp_tpu/utils/diagnostics.py
(the reference's device and extension report, ref main.cpp:150, 193-212):
each CUDA device's kind and memory, and a readable failure when the
requirements are not met.

``device_report`` lists every CUDA device (platform "gpu"), or the CPU
when there is none, as ``jax.devices()`` reports it.
"""

from __future__ import annotations

from typing import List

import torch


def device_report() -> List[dict]:
    if not torch.cuda.is_available():
        return [{"id": 0, "platform": "cpu", "device_kind": "cpu"}]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        out.append({
            "id": i,
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(i),
            "hbm_limit_gb": round(total / 2 ** 30, 2),
            "hbm_in_use_gb": round((total - free) / 2 ** 30, 3),
        })
    return out


def check_capabilities(min_devices: int = 1,
                       require_gpu: bool = False) -> List[dict]:
    """The device report, or a RuntimeError naming what is missing (the
    reference's 'unsupported extensions' throw, ref main.cpp:203-211)."""
    report = device_report()
    problems = []
    if len(report) < min_devices:
        problems.append(f"need >= {min_devices} devices, have {len(report)}")
    if require_gpu and not any(r["platform"] == "gpu" for r in report):
        problems.append(
            "GPU required but no CUDA device present "
            f"(platforms: {sorted({r['platform'] for r in report})})")
    if problems:
        raise RuntimeError("capability check failed: " + "; ".join(problems)
                           + f" — device report: {report}")
    return report


def print_report() -> None:
    for r in device_report():
        print(r)
