"""Checkpoint / resume (port of the text and npz paths of
matfac_tpu/train/checkpoint.py; sharded checkpoints are ROADMAP queue 1,
item 13).

The text files go through the JAX package's own numpy writers and readers
(``matfac_tpu.data.io``), so a factor file written here is byte-identical
to one the JAX package writes for the same values, and each package reads
the other's: ``{prefix}_uFac_{sig}.mat`` / ``_iFac_``, signature
``{nUsers}X{nItems}_{facDim}_{uReg}_{iReg}_{learnRate}``
(modelSignature, model.cpp:11-19), a bias model's biases beside them
(``save_full``), invalid sets as ``_invalUsers.txt`` / ``_invalItems.txt``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from matfac_tpu_torch.config import Params
from matfac_tpu_torch.data.io import (read_factor_mat, write_factor_mat,
                                      write_vector)
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


def load_facs(state: MFState, prefix: str, sig: str) -> Optional[MFState]:
    """loadFacs analog (model.cpp:104-128): None when a file is missing;
    the factors land on ``state``'s device."""
    up, ip = fac_paths(prefix, sig)
    if not (os.path.exists(up) and os.path.exists(ip)):
        return None
    u = read_factor_mat(up, *state.u_fac.shape)
    i = read_factor_mat(ip, *state.i_fac.shape)
    return state._replace(u_fac=torch.from_numpy(u).to(state.u_fac.device),
                          i_fac=torch.from_numpy(i).to(state.i_fac.device))


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
