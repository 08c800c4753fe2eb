"""Column normalization + Gram-Schmidt orthogonalization of CN frames (port
of ocn_tpu/ops/ortho.py: cn5's and cn1's ``orthogonalize``, cn6's
``orthogonalize3``).

The quirks of the reference math are kept on purpose:

* ``colnorm_quirk``: after replacing zero column sums by 1, columns whose
  sum equals exactly 1 get ``empty_fill`` (0.0 for cn5) instead of 1/1;
* the EMA inner product is a running mean over *training* chunks:
  n += 1; m <- (1-1/n) m + (1/n) <cn2, ncn1>;
* the inner product is divided by max|ncn1| over the batch before the
  projection (the raw value when that max is 0);
* the projected cn2 is re-normalized with the plain rule (zero sums -> 1).

Every column sum, inner product and maximum spans the chunk; in the mesh
step, whose ranks each hold rows of the chunk, they are reduced over "dp"
(parallel/shard.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ocn_tpu_torch.ops.frame import CNFrame, FrameIndex, entry_col_sums
from ocn_tpu_torch.parallel import shard


def colnorm_quirk(cn: CNFrame, empty_fill: float = 0.0,
                  fidx: Optional[FrameIndex] = None) -> CNFrame:
    """Column-normalize with the reference's cn1 rule; with ``fidx`` the
    column sums are taken per entry in the chunk's sorted domain."""
    if fidx is not None:
        s = entry_col_sums(cn.val[None], fidx)[0]
        s_rep = torch.where(s == 0, 1.0, s)
        inv = torch.where(s_rep != 1, 1.0 / s_rep, empty_fill)
        return cn.with_values(cn.val * inv)
    s = cn.col_sum()
    s_rep = torch.where(s == 0, 1.0, s)
    inv = torch.where(s_rep != 1, 1.0 / s_rep, empty_fill)
    return cn.scale_cols(inv)


def colnorm_plain(cn: CNFrame, fidx: Optional[FrameIndex] = None) -> CNFrame:
    """Column-normalize with the post-projection rule."""
    if fidx is not None:
        s = entry_col_sums(cn.val[None], fidx)[0]
        return cn.with_values(cn.val * (1.0 / torch.where(s == 0, 1.0, s)))
    s = cn.col_sum()
    return cn.scale_cols(1.0 / torch.where(s == 0, 1.0, s))


def ema_inner_product(cn2: CNFrame, ncn1: CNFrame, ema: torch.Tensor,
                      n: torch.Tensor, training: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Running-mean inner product update; returns (inner_product_to_use,
    new_ema, new_n).  In eval the stored value is returned unchanged."""
    if not training:
        return ema, ema, n
    batch_inner = cn2.inner(ncn1)
    new_n = n + 1
    beta = 1.0 / new_n.float()
    new_ema = (1.0 - beta) * ema + beta * batch_inner
    return new_ema, new_ema, new_n


def gram_schmidt(cn2: CNFrame, ncn1: CNFrame, inner_product: torch.Tensor) -> CNFrame:
    """cn2 <- cn2 - (inner/scale) * ncn1 on the union pattern."""
    scale = shard.dp_max(torch.abs(ncn1.val))
    nip = torch.where(scale > 0, inner_product / scale, inner_product)
    union = cn2.mask | ncn1.mask
    return cn2.with_values(torch.where(union, cn2.val - nip * ncn1.val, 0.0))


def orthogonalize(
    cn1: CNFrame,
    cn2: CNFrame,
    ema: torch.Tensor,
    n: torch.Tensor,
    training: bool,
    empty_fill: float = 0.0,
    fidx: Optional[FrameIndex] = None,
) -> Tuple[CNFrame, CNFrame, torch.Tensor, torch.Tensor]:
    """normalize -> EMA inner product -> Gram-Schmidt -> renormalize.
    Returns (ncn1, ocn2, new_ema, new_n).

    With ``fidx`` (frames sharing cn1.ids) one three-plane
    ``entry_col_sum_multi`` gives every column sum, using

        colsum(cn2 - nip*ncn1) = colsum(cn2) - nip * inv1 * colsum(cn1)

    (nip and the per-column inv1 are constant within a column).  The GS sum
    planes are masked by the raw pattern union so the gradients match the
    direct path's ``where(union, ...)`` exactly."""
    if fidx is None:
        ncn1 = colnorm_quirk(cn1, empty_fill)
        inner, new_ema, new_n = ema_inner_product(cn2, ncn1, ema, n, training)
        ocn2 = colnorm_plain(gram_schmidt(cn2, ncn1, inner))
        return ncn1, ocn2, new_ema, new_n
    u0 = (cn1.val != 0) | (cn2.val != 0)
    es = entry_col_sums(
        torch.stack([cn1.val, torch.where(u0, cn2.val, 0.0),
                     torch.where(u0, cn1.val, 0.0)]), fidx)
    es1, es2u, es1u = es[0], es[1], es[2]
    s_rep = torch.where(es1 == 0, 1.0, es1)
    inv1 = torch.where(s_rep != 1, 1.0 / s_rep, empty_fill)
    ncn1 = cn1.with_values(cn1.val * inv1)
    inner, new_ema, new_n = ema_inner_product(cn2, ncn1, ema, n, training)
    scale = shard.dp_max(torch.abs(ncn1.val))
    nip = torch.where(scale > 0, inner / scale, inner)
    union = cn2.mask | ncn1.mask
    val_o = torch.where(union, cn2.val - nip * ncn1.val, 0.0)
    es_o = es2u - nip * (inv1 * es1u)
    inv2 = 1.0 / torch.where(es_o == 0, 1.0, es_o)
    return ncn1, cn2.with_values(val_o * inv2), new_ema, new_n


def orthogonalize3(
    cn1: CNFrame,
    cn2: CNFrame,
    cn3: CNFrame,
    ema: torch.Tensor,
    n: torch.Tensor,
    training: bool,
    empty_fill: float = 0.0,
    fidx: Optional[FrameIndex] = None,
) -> Tuple[CNFrame, CNFrame, CNFrame, torch.Tensor, torch.Tensor]:
    """cn6's double Gram-Schmidt: quirk-normalize cn1, project cn2 off it
    and renormalize, then project cn3 off both and renormalize.  Returns
    (ncn1, ocn2, ocn3, new_ema, new_n).

    The reference's shared-EMA quirk is kept: the three inner products step
    ONE running mean in turn (n advances by 3 per training call), both cn3
    projections divide by max|ncn1|, and both cn3 coefficients read the
    buffer after the third step (nip1 == nip2).

    With ``fidx`` one five-plane ``entry_col_sum_multi`` gives every column
    sum; the post-projection sums follow as

        colsum(cn2 - nip0*ncn1)             = es2u - nip0*inv1*es1u  (es_o2)
        colsum(cn3 - nip1*ncn1 - nip2*ocn2) = es3u - nip1*inv1*es1u3
                                                   - nip2*inv2*es_o2

    with the planes masked by the raw unions so the gradients equal the
    direct path's.  Without ``fidx`` the direct path (the oracle) runs."""
    if fidx is None:
        ncn1 = colnorm_quirk(cn1, empty_fill)
        scale = shard.dp_max(torch.abs(ncn1.val))
        inner0, ema, n = ema_inner_product(cn2, ncn1, ema, n, training)
        nip0 = torch.where(scale > 0, inner0 / scale, inner0)
        ocn2 = colnorm_plain(cn2.with_values(torch.where(
            cn2.mask | ncn1.mask, cn2.val - nip0 * ncn1.val, 0.0)))
        _, ema, n = ema_inner_product(cn3, ncn1, ema, n, training)
        inner2, ema, n = ema_inner_product(cn3, ocn2, ema, n, training)
        nip = torch.where(scale > 0, inner2 / scale, inner2)
        union3 = cn3.mask | ncn1.mask | ocn2.mask
        ocn3 = colnorm_plain(cn3.with_values(torch.where(
            union3, cn3.val - nip * ncn1.val - nip * ocn2.val, 0.0)))
        return ncn1, ocn2, ocn3, ema, n
    u2 = (cn1.val != 0) | (cn2.val != 0)
    u3 = u2 | (cn3.val != 0)
    es = entry_col_sums(
        torch.stack([cn1.val, torch.where(u2, cn2.val, 0.0),
                     torch.where(u2, cn1.val, 0.0),
                     torch.where(u3, cn3.val, 0.0),
                     torch.where(u3, cn1.val, 0.0)]), fidx)
    es1, es2u, es1u, es3u, es1u3 = es.unbind(0)
    s_rep = torch.where(es1 == 0, 1.0, es1)
    inv1 = torch.where(s_rep != 1, 1.0 / s_rep, empty_fill)
    ncn1 = cn1.with_values(cn1.val * inv1)
    scale = shard.dp_max(torch.abs(ncn1.val))
    # cn2 off ncn1
    inner0, ema, n = ema_inner_product(cn2, ncn1, ema, n, training)
    nip0 = torch.where(scale > 0, inner0 / scale, inner0)
    val_o2 = torch.where(cn2.mask | ncn1.mask, cn2.val - nip0 * ncn1.val, 0.0)
    es_o2 = es2u - nip0 * (inv1 * es1u)
    inv2 = 1.0 / torch.where(es_o2 == 0, 1.0, es_o2)
    ocn2 = cn2.with_values(val_o2 * inv2)
    # cn3 off ncn1 and ocn2; both coefficients read the buffer after the
    # third step
    _, ema, n = ema_inner_product(cn3, ncn1, ema, n, training)
    inner2, ema, n = ema_inner_product(cn3, ocn2, ema, n, training)
    nip = torch.where(scale > 0, inner2 / scale, inner2)
    union3 = cn3.mask | ncn1.mask | ocn2.mask
    val_o3 = torch.where(union3, cn3.val - nip * ncn1.val - nip * ocn2.val, 0.0)
    es_o3 = es3u - nip * (inv1 * es1u3) - nip * (inv2 * es_o2)
    inv3 = 1.0 / torch.where(es_o3 == 0, 1.0, es_o3)
    return ncn1, ocn2, cn3.with_values(val_o3 * inv3), ema, n
