"""Run state carried across packages as numpy arrays.

The JAX package's ``NetState`` / ``FaultSpec`` leaves convert with
``np.asarray``; these helpers build the port's tensors from them and hand
the port's back, so a state can move between the two packages and a port
plane stack can be compared word for word with
``benor_tpu.ops.pallas_round.pack_state``.
"""

from __future__ import annotations

import numpy as np
import torch

from .state import FaultSpec, NetState


def state_from_numpy(x, decided, k, killed, device="cpu") -> NetState:
    """NetState leaves as numpy arrays -> the port's NetState."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return NetState(x=t(x, torch.int8), decided=t(decided, torch.bool),
                    k=t(k, torch.int32), killed=t(killed, torch.bool))


def faults_from_numpy(faulty, crash_round, recover_round=None,
                      device="cpu") -> FaultSpec:
    """FaultSpec leaves as numpy arrays -> the port's FaultSpec."""
    def t(a, dtype):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return FaultSpec(
        faulty=t(faulty, torch.bool), crash_round=t(crash_round, torch.int32),
        recover_round=(None if recover_round is None
                       else t(recover_round, torch.int32)))


def mask_from_numpy(mask, device="cpu") -> torch.Tensor:
    """A delivery mask (bool [T, R, S], any array-like) -> the port's
    contiguous ``torch.bool`` tensor, one byte of 0 or 1 per edge."""
    arr = np.ascontiguousarray(np.asarray(mask, dtype=bool))
    return torch.from_numpy(arr).to(device)


def state_to_numpy(state: NetState) -> dict:
    """The port's NetState -> {x int8, decided bool, k int32, killed bool}."""
    return {"x": state.x.cpu().numpy().astype(np.int8),
            "decided": state.decided.cpu().numpy().astype(bool),
            "k": state.k.cpu().numpy().astype(np.int32),
            "killed": state.killed.cpu().numpy().astype(bool)}


def pack_to_numpy(pack: torch.Tensor) -> np.ndarray:
    """A port plane stack (int32 words) -> numpy uint32, the JAX pack's type."""
    return pack.cpu().numpy().view(np.uint32)
