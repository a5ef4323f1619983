"""Checkpoint / resume (port of matfac_tpu/train/checkpoint.py: the text,
binary, npz and sharded paths).

The files go through the port's copies of the JAX package's numpy writers
and readers (``data/io.py``), so a file written here is byte-identical to
one the JAX package writes for the same values, and each package reads
the other's: ``{prefix}_uFac_{sig}.mat`` / ``_iFac_``, signature
``{nUsers}X{nItems}_{facDim}_{uReg}_{iReg}_{learnRate}``
(modelSignature, model.cpp:11-19), a bias model's biases and mu beside
them (``save_full`` / ``load_full``), the reference's float64 binaries
(``save_bin_facs`` / ``load_bin_facs``), invalid sets as
``_invalUsers.txt`` / ``_invalItems.txt``. Every reader returns tensors
on the device of the ``state`` it is given.

Sharded checkpoints (``save_sharded`` / ``restore_sharded``) are a torch
format of the port's own: a directory of one ``rows_{p}.pt`` file per
process, rank p writing the contiguous rows it owns of every table
(``distributed.host_user_range`` over the processes), and a
``manifest.pt`` with the shapes, dtypes, mu and the extras, written by
rank 0. Every process takes part in both calls. They are not byte
compatible with the JAX package's orbax checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.io import (read_factor_mat, read_factor_mat_bin,
                                      read_vector, write_factor_mat,
                                      write_factor_mat_bin, write_vector)
from matfac_tpu_torch.models.base import MFState, state_to_numpy

_FIELDS = MFState._fields


def model_signature(params: Params, n_users: int, n_items: int) -> str:
    """modelSignature analog (model.cpp:11-19)."""
    return (f"{n_users}X{n_items}_{params.fac_dim}_{params.u_reg}"
            f"_{params.i_reg}_{params.learn_rate}")


def fac_paths(prefix: str, sig: str) -> Tuple[str, str]:
    return (f"{prefix}_uFac_{sig}.mat", f"{prefix}_iFac_{sig}.mat")


def save_facs(state: MFState, prefix: str, sig: str) -> Tuple[str, str]:
    """saveFacs analog (model.cpp:89-101): text factor matrices."""
    up, ip = fac_paths(prefix, sig)
    write_factor_mat(state.u_fac.detach().cpu().numpy(), up)
    write_factor_mat(state.i_fac.detach().cpu().numpy(), ip)
    return up, ip


def bias_paths(prefix: str, sig: str) -> Tuple[str, str, str]:
    """Model::save's bias file names (model.cpp:43-57); the global bias is
    ``{prefix}_{sig}_gBias`` (the signature before the name, no suffix)."""
    return (f"{prefix}_uBias_{sig}.vec", f"{prefix}_iBias_{sig}.vec",
            f"{prefix}_{sig}_gBias")


def save_full(state: MFState, prefix: str, sig: str) -> None:
    """Model::save analog (model.cpp:31-58): the factors, uBias / iBias one
    value a line, and mu as a one-value vector."""
    save_facs(state, prefix, sig)
    ub, ib, gb = bias_paths(prefix, sig)
    write_vector(state.u_bias.detach().cpu().numpy(), ub)
    write_vector(state.i_bias.detach().cpu().numpy(), ib)
    write_vector(np.asarray([float(state.mu)]), gb)


def _facs_on(state: MFState, u: np.ndarray, i: np.ndarray) -> MFState:
    return state._replace(u_fac=torch.from_numpy(u).to(state.u_fac.device),
                          i_fac=torch.from_numpy(i).to(state.i_fac.device))


def load_facs(state: MFState, prefix: str, sig: str) -> Optional[MFState]:
    """loadFacs analog (model.cpp:104-128): None when a file is missing;
    the factors land on ``state``'s device."""
    up, ip = fac_paths(prefix, sig)
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    return _facs_on(state, read_factor_mat(up, *state.u_fac.shape),
                    read_factor_mat(ip, *state.i_fac.shape))


def load_full(state: MFState, prefix: str, sig: str) -> Optional[MFState]:
    """Model::load analog (model.cpp:61-86): factors, biases and mu,
    existence-checked as a set (a factors-only checkpoint loads through
    ``load_facs``); float32 tensors on ``state``'s devices."""
    st = load_facs(state, prefix, sig)
    if st is None:
        return None
    ub, ib, gb = bias_paths(prefix, sig)
    if not (os.path.exists(ub) and os.path.exists(ib)
            and os.path.exists(gb)):
        return None
    as_f32 = lambda a, like: torch.from_numpy(
        np.asarray(a, np.float32)).to(like.device)
    return st._replace(u_bias=as_f32(read_vector(ub), state.u_bias),
                       i_bias=as_f32(read_vector(ib), state.i_bias),
                       mu=as_f32(read_vector(gb)[0], state.mu))


def bin_fac_paths(prefix: str, sig: str) -> Tuple[str, str]:
    return (f"{prefix}_uFac_{sig}.binmat", f"{prefix}_iFac_{sig}.binmat")


def save_bin_facs(state: MFState, prefix: str, sig: str
                  ) -> Tuple[str, str]:
    """saveBinFacs analog (model.cpp:131-140): reference-bit-format
    ``{prefix}_uFac_{sig}.binmat`` raw float64 streams."""
    up, ip = bin_fac_paths(prefix, sig)
    write_factor_mat_bin(state.u_fac.detach().cpu().numpy(), up)
    write_factor_mat_bin(state.i_fac.detach().cpu().numpy(), ip)
    return up, ip


def load_bin_facs(state: MFState, prefix: str, sig: str
                  ) -> Optional[MFState]:
    """loadBinFacs analog (model.cpp:143-159): existence-checked; reads
    binaries written by the reference (headerless f64 row-major) onto
    ``state``'s device."""
    up, ip = bin_fac_paths(prefix, sig)
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    return _facs_on(state, read_factor_mat_bin(up, *state.u_fac.shape),
                    read_factor_mat_bin(ip, *state.i_fac.shape))


def save_invalid(prefix: str, invalid_users: np.ndarray,
                 invalid_items: np.ndarray) -> None:
    """main.cpp:1387-1393 analog: one id per line."""
    np.savetxt(prefix + "_invalUsers.txt",
               np.nonzero(invalid_users)[0], fmt="%d")
    np.savetxt(prefix + "_invalItems.txt",
               np.nonzero(invalid_items)[0], fmt="%d")


def load_invalid(prefix: str, n_users: int, n_items: int
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    up, ip = prefix + "_invalUsers.txt", prefix + "_invalItems.txt"
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    u = np.zeros(n_users, bool)
    i = np.zeros(n_items, bool)
    u[np.loadtxt(up, dtype=np.int64, ndmin=1)] = True
    i[np.loadtxt(ip, dtype=np.int64, ndmin=1)] = True
    return u, i


def save_state(path: str, state: MFState, **extra) -> None:
    """Full state + loop progress as .npz (the JAX package's layout)."""
    np.savez(path, **dict(zip(_FIELDS, state_to_numpy(state))), **extra)


def load_state(path: str, device="cuda") -> Tuple[MFState, dict]:
    with np.load(path) as z:
        state = MFState(*(torch.from_numpy(z[f]).to(device)
                          for f in _FIELDS))
        extra = {k: z[k] for k in z.files if k not in _FIELDS}
    return state, extra


def save_sharded(path: str, state: MFState, **extra) -> None:
    """Write ``state`` (whole tables in every process, as the mesh solvers
    hand them back) as a sharded checkpoint directory: each process its
    own rows, rank 0 the manifest. Collective: every process calls it."""
    from matfac_tpu_torch.parallel import distributed
    path = os.path.abspath(path)
    me, world = distributed.process_index(), distributed.process_count()
    os.makedirs(path, exist_ok=True)
    rows = {}
    for f in ("u_fac", "i_fac", "u_bias", "i_bias"):
        t = getattr(state, f)
        lo, hi = distributed.host_user_range(t.shape[0], world, me)
        rows[f] = t[lo:hi].detach().cpu().clone()
    torch.save(rows, os.path.join(path, f"rows_{me}.pt"))
    if me == 0:
        torch.save({"world": world,
                    "shapes": {f: tuple(getattr(state, f).shape)
                               for f in _FIELDS},
                    "mu": state.mu.detach().cpu().clone(),
                    "extra": {k: np.asarray(v) for k, v in extra.items()}},
                   os.path.join(path, "manifest.pt"))
    distributed.barrier()


def restore_sharded(path: str, like: MFState) -> Tuple[MFState, dict]:
    """Read a ``save_sharded`` directory back into whole tables with the
    device and dtype of ``like``'s tables; returns (state, extras). Every
    process reads every process's rows, so the checkpoint restores under
    any process count."""
    path = os.path.abspath(path)
    man = torch.load(os.path.join(path, "manifest.pt"), weights_only=False)
    parts = [torch.load(os.path.join(path, f"rows_{p}.pt"),
                        weights_only=False) for p in range(man["world"])]
    out = {}
    for f in _FIELDS:
        ref = getattr(like, f)
        t = man["mu"] if f == "mu" else torch.cat([pt[f] for pt in parts])
        if tuple(t.shape) != tuple(man["shapes"][f]):
            raise ValueError(f"{path}: {f} rows {tuple(t.shape)} != "
                             f"{man['shapes'][f]}")
        out[f] = t.to(device=ref.device, dtype=ref.dtype)
    return MFState(**out), man["extra"]
