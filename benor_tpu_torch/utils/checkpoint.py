"""Checkpoint and resume (port of benor_tpu/utils/checkpoint.py:32-152).

A checkpoint is one ``.npz`` holding the state and fault arrays, the round
the loop would run next and the config as JSON, in the JAX package's
format (version 2, the same keys, ``recover_round`` and ``mesh_shape``
only where they apply), so a checkpoint written by either package resumes
in the other.  ``key_data`` is the raw threefry key ``jax.random.key(
cfg.seed)`` holds, ``[0, seed mod 2^32]`` as uint32: the port keys every
stream on ``cfg.seed``, so it writes that key and refuses a checkpoint
whose key its config's seed does not give.  Every draw is keyed on (seed,
round, phase, trial, node), never on the loop's history, so a resumed run
equals the uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig, unported
from ..state import FaultSpec, NetState

_FORMAT_VERSION = 2


def key_data(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.key(seed)`` (threefry, 32-bit seeds):
    uint32 [2]."""
    return np.asarray([0, int(seed) % 2**32], dtype=np.uint32)


def save_checkpoint(path: str, cfg: SimConfig, state: NetState,
                    faults: FaultSpec, next_round: int, base_key=None,
                    mesh_shape: Optional[Tuple[int, int]] = None) -> None:
    """Snapshot a (possibly mid-run) simulation to ``path`` (.npz),
    atomically.  ``next_round`` is the round the loop would run next
    (``run_consensus_slice``'s first return).  ``base_key``, where given,
    is the raw key data of the run's key, which must be ``cfg.seed``'s.
    ``mesh_shape`` records a grid as provenance only."""
    if base_key is not None and not np.array_equal(
            np.asarray(base_key, np.uint32), key_data(cfg.seed)):
        raise ValueError("the port keys every stream on cfg.seed: "
                         "base_key must be that seed's key")

    def host(t):
        return t.cpu().numpy()
    payload = {
        "key_data": key_data(cfg.seed),
        "x": host(state.x),
        "decided": host(state.decided),
        "k": host(state.k),
        "killed": host(state.killed),
        "faulty": host(faults.faulty),
        "crash_round": host(faults.crash_round),
        "next_round": np.int32(next_round),
        "version": np.int32(_FORMAT_VERSION),
        "config_json": np.bytes_(
            json.dumps(dataclasses.asdict(cfg)).encode()),
    }
    if faults.recover_round is not None:
        payload["recover_round"] = host(faults.recover_round)
    if mesh_shape is not None:
        payload["mesh_shape"] = np.asarray(
            [int(s) for s in mesh_shape], dtype=np.int32)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)  # atomic: no torn checkpoints on a crash


def load_checkpoint(path: str, device=None):
    """Load a checkpoint onto ``device`` -> (cfg, state, faults,
    next_round, key_data).  Raises ``ValueError`` on another format
    version, or on a key the config's seed does not give."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        # v1 archives that already carry key_data load as v2 ones do
        if version != _FORMAT_VERSION and not (
                version == 1 and "key_data" in z.files):
            raise ValueError(f"unsupported checkpoint version {version}")
        raw = json.loads(bytes(z["config_json"]).decode())
        if raw.get("mesh_shape") is not None:
            raw["mesh_shape"] = tuple(raw["mesh_shape"])
        cfg = SimConfig(**raw)
        kd = np.asarray(z["key_data"], np.uint32)
        if not np.array_equal(kd, key_data(cfg.seed)):
            raise ValueError(
                f"checkpoint key {kd.tolist()} is not the key of "
                f"cfg.seed={cfg.seed}; the port keys every stream on "
                "cfg.seed")

        def dev(name):
            return torch.from_numpy(np.array(z[name])).to(device)
        state = NetState(x=dev("x"), decided=dev("decided"), k=dev("k"),
                         killed=dev("killed"))
        faults = FaultSpec(
            faulty=dev("faulty"), crash_round=dev("crash_round"),
            recover_round=(dev("recover_round")
                           if "recover_round" in z.files else None))
        next_round = int(z["next_round"])
    return cfg, state, faults, next_round, kd


def saved_mesh_shape(path: str) -> Optional[Tuple[int, int]]:
    """The (trial_shards, node_shards) recorded in ``path``, or None."""
    with np.load(path, allow_pickle=False) as z:
        if "mesh_shape" not in z.files:
            return None
        t, n = (int(v) for v in z["mesh_shape"])
    return t, n


def resume_from(path: str, mesh=None, device=None):
    """Load ``path`` and run the loop to termination on ``device`` (CUDA
    unless ``"cpu"``) -> (rounds_executed_total, final_state, faults),
    rounds counted from the start of the original run.  ``mesh="auto"``
    resumes on one device, as the JAX package does where the recorded
    grid's devices are not there; any other mesh raises
    ``NotImplementedError`` (ROADMAP Queue A item 15)."""
    from ..sim import resolve_device, resume_consensus

    if mesh is not None and mesh != "auto":
        unported("resume_from(mesh=...) (sharded resume)", "15")
    cfg, state, faults, next_round, _ = load_checkpoint(
        path, resolve_device(device))
    out = resume_consensus(cfg, state, faults, next_round)
    return out[0], out[1], faults
