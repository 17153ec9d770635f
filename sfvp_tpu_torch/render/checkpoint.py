"""Checkpoint / resume, in the npz format of sfvp_tpu.render.checkpoint:
the accumulator, step counter and ray counter with the config hash, so a
checkpoint written by either package resumes in the other."""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..integrate.wavefront import RenderState

_FORMAT_VERSION = 1


def save_checkpoint(path: str, state: RenderState, config_hash: str) -> None:
    tmp = path + ".tmp"
    np.savez(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        accum=state.accum.cpu().numpy(),
        frame=np.int32(state.frame),
        mrays=np.float32(state.mrays.item()),
        config_hash=np.bytes_(config_hash.encode()),
    )
    # numpy appends .npz to the tmp name
    os.replace(tmp + ".npz", path)


def load_checkpoint(
    path: str, expected_config_hash: Optional[str] = None, *, device
) -> Tuple[RenderState, str]:
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {z['version']}")
        got_hash = bytes(z["config_hash"]).decode()
        if expected_config_hash is not None and got_hash != expected_config_hash:
            raise ValueError(
                f"checkpoint config hash {got_hash} != expected "
                f"{expected_config_hash}; refusing to resume into a "
                "different render configuration"
            )
        state = RenderState(
            accum=torch.from_numpy(np.asarray(z["accum"], np.float32)).to(device),
            frame=int(z["frame"]),
            mrays=torch.tensor(float(z["mrays"]), dtype=torch.float32,
                               device=device),
        )
    return state, got_hash
