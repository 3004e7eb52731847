"""Reversible backprop through a Glow block's K flows. Port of
``mcgm_tpu/ops/reversible.py`` (``make_reversible_stack``).

The flows are bijections, so the backward pass rebuilds each flow's input
from its output instead of keeping it. :func:`reversible_flows` is one
``torch.autograd.Function`` over a block's flows:

- forward: the K flows without autograd; it keeps the final carry, the
  indicator and references to the flows (their parameters are the
  function's inputs), and no per-flow activation;
- backward, per flow from the last: the coupling net runs once on the
  passthrough half ``y_a`` with autograd on (on the card its gated 1x1 is
  ``mc_gated_matmul``'s ``autograd.Function``, so ``alpha`` / ``beta`` get
  their gradients from its backward); ``in_b = y_b / s - t`` is rebuilt
  from the same ``(s, t)``; the affine coupling's cotangents are formed by
  hand (``ct_s = ct_y_b * (in_b + t) + ct_ld / s``, ``ct_log_s = ct_s * s *
  (1 - s)``) and taken through the net with ``torch.autograd.grad``; the
  invconv is inverted with ``inv(W)`` (every flow's, once per backward) and
  ActNorm analytically, and their VJP is taken at the rebuilt input.

The work is the ``remat_flows`` step's (one net forward and one net VJP per
flow in the backward); the memory of the saved flow inputs is gone. The
only error the rebuild adds is f32 rounding of the inversions, compounded
over K flows.

``RECONSTRUCTED``: when it is a list, each backward appends ``(flow index,
rebuilt input)`` per flow, last flow first (a check of the rebuild; off by
default).
"""

from __future__ import annotations

import torch

RECONSTRUCTED: list | None = None


def _invconv_weight(ic) -> torch.Tensor:
    """The invconv's ``[C, C]`` weight: recomposed from its LU factors, or
    the plain one's parameter."""
    w = ic.weight
    return w if isinstance(w, torch.Tensor) else w()


def _channels_matmul(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    b, c, h, wd = x.shape
    return torch.matmul(w, x.reshape(b, c, h * wd)).reshape(b, -1, h, wd)


def _grads(outputs, inputs, cotangents):
    """``torch.autograd.grad`` with a zero for an input the outputs do not
    reach."""
    got = torch.autograd.grad(outputs, inputs, cotangents, allow_unused=True)
    return [torch.zeros_like(i) if g is None else g for g, i in zip(got, inputs)]


class _ReversibleFlows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flows, indicator, dtype, plain, x, *params):
        out = x
        logdet = torch.zeros((x.shape[0],), device=x.device)
        for flow in flows:
            out, det = flow(out, indicator, dtype, False, plain)
            logdet = logdet + det
        ctx.flows, ctx.dtype, ctx.plain = flows, dtype, plain
        ctx.save_for_backward(out, indicator)
        return out, logdet

    @staticmethod
    def backward(ctx, ct_y, ct_ld):
        y, indicator = ctx.saved_tensors
        flows, dtype, plain = ctx.flows, ctx.dtype, ctx.plain
        ct_ld_sum = ct_ld.sum()  # the scalar dets' cotangent (ActNorm, invconv)
        with torch.no_grad():
            inv_w = torch.linalg.inv(torch.stack([_invconv_weight(f.invconv) for f in flows]))
        grads = []
        for k in range(len(flows) - 1, -1, -1):
            flow = flows[k]
            coupling = flow.coupling
            y_a, y_b = y.detach().chunk(2, 1)
            ct_y_a, ct_y_b = ct_y.chunk(2, 1)
            net_params = list(coupling.parameters())
            # the coupling: one net forward serves the rebuild and the VJP
            with torch.enable_grad():
                a = y_a.detach().requires_grad_(True)
                h = coupling.net(a, indicator, dtype, False, plain)
            with torch.no_grad():
                hd = h.detach()
                if coupling.affine:
                    log_s, t = hd.chunk(2, 1)
                    s = torch.sigmoid(log_s + 2.0)
                    v_b = y_b / s - t
                    ct_t = ct_y_b * s
                    ct_s = ct_y_b * (v_b + t) + ct_ld.reshape(-1, 1, 1, 1) / s
                    ct_h = torch.cat([ct_s * (s * (1.0 - s)), ct_t], 1)
                    ct_vb = ct_t
                else:
                    v_b = y_b - hd
                    ct_h = ct_vb = ct_y_b
            ct_a, *net_grads = _grads(h, [a, *net_params], ct_h.to(h.dtype))
            del h
            with torch.no_grad():
                v = torch.cat([y_a, v_b], 1)
                ct_v = torch.cat([ct_y_a + ct_a.to(ct_y_a.dtype), ct_vb], 1)
                an = flow.actnorm
                x = (_channels_matmul(inv_w[k], v) / an.scale[None, :, None, None]
                     - an.loc[None, :, None, None])
            if RECONSTRUCTED is not None:
                RECONSTRUCTED.append((k, x.detach().clone()))
            # ActNorm and the invconv: their VJP at the rebuilt input
            ai_params = list(an.parameters()) + list(flow.invconv.parameters())
            with torch.enable_grad():
                xg = x.detach().requires_grad_(True)
                u, d_an = an(xg)
                out, d_ic = flow.invconv(u)
                ct_x, *ai_grads = _grads([out, d_an + d_ic], [xg, *ai_params],
                                         [ct_v, ct_ld_sum.to(d_an.dtype)])
            by_id = {id(p): g for p, g in zip(ai_params + net_params, ai_grads + net_grads)}
            grads.append([by_id[id(p)] for p in flow.parameters()])
            y, ct_y = x, ct_x
        grads.reverse()
        return (None, None, None, None, ct_y, *(g for per in grads for g in per))


def reversible_flows(flows: list, x: torch.Tensor, indicator: torch.Tensor, dtype,
                     plain: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y, logdet [B])`` of the flows ``flows`` applied in order to ``x``,
    with the reversible backward."""
    params = [p for flow in flows for p in flow.parameters()]
    return _ReversibleFlows.apply(list(flows), indicator, dtype, plain, x, *params)
