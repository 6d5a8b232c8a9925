"""Plain PyTorch version of the bsw kernel: the lockstep batch of
``core.bsw`` (``bsw_init_state`` + one ``bsw_row_step`` per target row),
with the kernel's padded array interface."""

from __future__ import annotations

import torch

from ...core.bsw import BSWParams, bsw_init_state, bsw_row_step


def bsw_ref(qs: torch.Tensor, ts: torch.Tensor, qlens, tlens, h0s, ws,
            p: BSWParams) -> torch.Tensor:
    """qs (W, qmax) / ts (W, tmax) int32 (pad code 4); qlens, tlens, h0s,
    ws (W,) int32 -> (6, W) int32: score, qle, tle, gtle, gscore, max_off."""
    qmax, tmax = qs.shape[1], ts.shape[1]
    st = bsw_init_state(qlens, h0s, p.o_ins + p.e_ins, p.e_ins, qmax)
    for i in range(tmax):
        # rows past every task's last live row change nothing
        if not bool((st[-1] & (i < tlens)).any()):
            break
        st = bsw_row_step(i, st, qs, ts, qlens, tlens, h0s, ws, p.a, p.b,
                          p.o_del, p.e_del, p.o_ins, p.e_ins, p.zdrop, qmax)
    (_, _, _, _, max_, max_i, max_j, max_ie, gscore, max_off, _) = st
    return torch.stack([max_, max_j + 1, max_i + 1, max_ie + 1, gscore,
                        max_off])
