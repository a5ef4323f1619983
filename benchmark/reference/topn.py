"""Full-catalog top-N in plain PyTorch: each score <U[u], V[i]> (f32 with
TF32 off), the user's train items and the items without a train rating
excluded, the n best in descending order. Worked out again from the
inputs: the exclusion lists from the train positives."""

from __future__ import annotations

import torch

from benchmark.reference import _eval


def follow(inp: dict, users, served_ids, n: int, dtype=torch.float32):
    """For the users of the sampled requests (int64 [B]) and the items the
    program served them ([B, n]): (the reference's n best scores [B, n],
    the reference's score of each served item [B, n], -inf where the item
    may not be served), f32."""
    _eval.no_tf32()
    U, V = inp["U"].to(dtype), inp["V"].to(dtype)
    nu, ni = inp["n_users"], inp["n_items"]
    _, vi = _eval.valid(inp["train"], nu, ni)
    excl = _eval.exclusions(inp["train"], nu)
    best, at = [], []
    ok_id = (served_ids >= 0) & (served_ids < ni)
    safe = torch.where(ok_id, served_ids, 0)
    for s in range(0, users.numel(), 2048):
        sc = _eval.scores(U, V, users[s:s + 2048], excl, ~vi)
        best.append(torch.topk(sc, n, dim=1).values)
        at.append(sc.gather(1, safe[s:s + 2048]))
    at = torch.cat(at)
    return torch.cat(best), torch.where(ok_id, at, -torch.inf)


def serve(inp: dict, users, n: int, dtype=torch.float32,
          tf32: bool = False):
    """(scores [B, n] f32, ids [B, n] int64): the reference's own answers,
    the products in ``dtype``, on the tensor cores' TF32 with ``tf32``
    (the controls at a lower precision)."""
    U, V = inp["U"].to(dtype), inp["V"].to(dtype)
    nu, ni = inp["n_users"], inp["n_items"]
    _, vi = _eval.valid(inp["train"], nu, ni)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        return _eval.topn(U, V, users, _eval.exclusions(inp["train"], nu),
                          ~vi, n)
    finally:
        _eval.no_tf32()
