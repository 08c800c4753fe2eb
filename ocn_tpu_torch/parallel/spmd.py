"""The explicit data-parallel step (port of ocn_tpu/parallel/spmd.py,
``make_spmd_train_step``).

Each rank of the "dp" group owns a contiguous shard of the link batch and
computes the single-device loss on it: the encoder over the graph masked
with the WHOLE batch's target links (as the reference masks them), its own
chunks scored in order (its positive chunks, then its negative ones), the
loss over its shard.  Loss, gradients and the float EMA buffers are then
averaged over the ranks (``pmean``), and every rank takes the same Adam
step.  The graph and the features are replicated.  As in the JAX package
the step scores chunk by chunk, on the plain CSR windows (no ELL tables, no
A^3 table).  Each rank draws from a generator of its own, seeded from the
shared one and its rank (JAX folds the key with the device index).
"""
from __future__ import annotations

import torch

from ocn_tpu_torch.parallel.sharded_graph import average_ema, rank_generator


def make_spmd_train_step(tr, mesh):
    """The explicit DP step of Trainer ``tr`` over ``mesh``'s "dp" group:
    step(state, pos, neg, mask_positions, gen) -> (state, loss), with
    pos/neg (2, B) and B divisible by dp; ``mask_positions`` the batch's
    CSR nnz positions (or None)."""
    cfg = tr.cfg
    ndev, me = mesh.dp, mesh.dp_rank

    def local_loss(state, pos, neg, g, gen):
        b = pos.shape[1]
        c = min(tr._chunk(), b)
        chunks = [(e[:, i:i + c], j == 0) for j, e in enumerate((pos, neg))
                  for i in range(0, b, c)]
        state.encoder.train()
        state.predictor.train()
        h = state.encoder(tr.x, g, gen)
        valid = torch.ones(c, dtype=tr.dtype, device=tr.device)
        zero = torch.zeros_like(valid)
        out = torch.cat([
            tr._score_chunk(state, h, g, e, valid, gen, True, tr.adj2,
                            corr=(valid if positive else zero)
                            if cfg.maskinput and tr.adj2 is not None else None)
            for e, positive in chunks])
        return tr._loss(out[:b], out[b:])

    def step(state, pos, neg, mask_positions, gen):
        bl = pos.shape[1] // ndev
        # every rank masks the whole batch's edges, as the reference does
        g = tr.g if mask_positions is None else tr.g.mask_edges(mask_positions)
        loss = local_loss(state, pos[:, me * bl:(me + 1) * bl],
                          neg[:, me * bl:(me + 1) * bl], g,
                          rank_generator(gen, me, tr.device))
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        params = list(state.encoder.parameters()) + list(state.predictor.parameters())
        mesh.comm.sum_grads(params, mesh.dp_group, ndev)
        with torch.no_grad():
            for p in params:
                if p.grad is not None:
                    p.grad.div_(ndev)
        average_ema(state, mesh)
        state.opt.step()
        loss = loss.detach()
        if ndev > 1:
            loss = mesh.comm.all_reduce(loss, mesh.dp_group) / ndev
        return state, loss

    return step
