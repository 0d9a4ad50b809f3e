"""The autodiff-in-kernel probe set (K6) on hand-written Hopper kernels.

Counterpart of ``benchmarks/ad_in_kernel_probe.py`` at the repo root, whose
probes take ``jax.grad`` of a loss inside a Pallas kernel body. Here each
probe's loss is one body written over an op set (``ops/probe_autograd.py``):
with :data:`KERNEL_OPS` every op is a ``torch.autograd.Function`` whose
forward and backward launch the probe kernels; with :data:`PLAIN_OPS` the
same body is plain PyTorch and ``torch.autograd`` derives its gradient.
Each probe holds the first gradient to the second at the JAX probe's
tolerance, with the same names and shapes.

Each probe computes what the JAX kernel body computes. For ``ad_full_chain``
that is ``droll(x, 32, 2)``, which moves element i to i + 32 (as every
``pltpu.roll`` does); the JAX probe's own reference ``loss_ref`` rolls by
-32 instead, and on 128 lanes the two differ (ROADMAP.md, section C).

Each :class:`Probe`'s ``grads`` takes the JAX kernel's arguments in their
order and returns its outputs, so the CPU tests feed it the JAX probes'
recorded inputs.

Run on the card::

    python -m multimodal_fl_security_tpu_torch.benchmarks.ad_in_kernel_probe

prints one line per probe and a JSON summary; exits non-zero if a probe
fails. ``--device cpu`` runs every kernel's plain version instead.
"""

from __future__ import annotations

import dataclasses
import sys
import traceback
from typing import Callable, Dict, List

import torch

from multimodal_fl_security_tpu_torch.benchmarks.mosaic_probe import (
    compare,
    report,
)
from multimodal_fl_security_tpu_torch.ops.probe_autograd import (
    KERNEL_OPS,
    PLAIN_OPS,
)


def _grads(loss, inputs, wrt):
    leaves = [t.detach().clone().requires_grad_(i in wrt)
              for i, t in enumerate(inputs)]
    out = loss(*leaves)
    return torch.autograd.grad(out, [leaves[i] for i in wrt])


#: the probes' row mask: rows % 4 < 3 on axis 1
ROW_KEEP = (1, (4, 0, 3))


def loss_roll(ops, x):
    y = ops.roll(x, 96, 2) * 0.5 + ops.roll(x, 4, 1)
    return (y * y).sum()


def loss_mask_relu_max(ops, x):
    a = ops.mask_relu(x, *ROW_KEEP)
    b = ops.max2(a, ops.roll(a, 64, 2))
    return b.sum()


def loss_batched_dot(ops, x, w):
    # The JAX body's batched dot and its sum over the 28 slots, as one
    # contraction over (slot, lane).
    return ops.mask_relu(ops.dot_rl(x, w), 0, None).sum()


def loss_wgrad2d(ops, a, d):
    w = ops.wgrad(a.reshape(1920, 128), d.reshape(1920, 256))
    return (w * w).sum()


def loss_softmax_ce(ops, z, onehot):
    return ops.ce(z, onehot).sum() / 32.0


def loss_full_chain(ops, w1, w2, x, onehot):
    """The JAX kernel body of ``p_ad_chain``: three rolled taps of a
    batched dot, relu and a row mask, an i-pair max and a lane max, fc
    over the row slots (one contraction over (slot, lane)), the masked
    CE."""
    z = None
    for t, sh in enumerate((0, 32, 64)):
        a = ops.roll(x, sh, 2) if sh else x
        part = ops.dot(a.reshape(1, 1920, 128), w1[3 * t][None])
        z = part if z is None else z + part
    h = ops.mask_relu(z.reshape(32, 60, 256), *ROW_KEEP)
    p = ops.pair_max(h[:, :56].reshape(32, 7, 2, 4, 256), 2)
    p = p.reshape(32, 28, 256)
    p = ops.max2(p, ops.roll(p, 128, 2))[:, :, :128]
    z2 = ops.dot_rl(p.transpose(0, 1), w2)              # [32, 128]
    z2 = ops.mask_relu(z2, 0, None)
    return ops.ce(z2, onehot).sum() / 32.0


def _onehot(gen, device):
    lab = torch.randint(0, 10, (32,), generator=gen, device=device)
    return torch.nn.functional.one_hot(lab, 128).float()


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: the loss body, its inputs from a generator, the indices
    of the inputs it differentiates, and the tolerance (rtol, atol)."""

    name: str
    loss: Callable
    make: Callable[[torch.Generator, torch.device], tuple]
    wrt: tuple
    tol: tuple

    def grads(self, *inputs, ops=KERNEL_OPS):
        """The JAX kernel's outputs: the gradients, through ``ops``."""
        g = _grads(lambda *t: self.loss(ops, *t), inputs, self.wrt)
        return g[0] if len(g) == 1 else tuple(g)


def _normal(*specs):
    def make(gen, device):
        return tuple(scale * torch.randn(shape, generator=gen, device=device)
                     for shape, scale in specs)
    return make


def _ce_make(gen, device):
    return (torch.randn((32, 128), generator=gen, device=device),
            _onehot(gen, device))


def _chain_make(gen, device):
    x, w1, w2 = _normal(((32, 60, 128), 0.5), ((9, 128, 256), 0.05),
                        ((28, 128, 128), 0.05))(gen, device)
    return x, w1, w2, _onehot(gen, device)


PROBES: List[Probe] = [
    Probe("ad_roll", loss_roll, _normal(((32, 60, 128), 1.0)), (0,),
          (1e-4, 1e-5)),
    Probe("ad_mask_relu_max", loss_mask_relu_max,
          _normal(((32, 60, 128), 1.0)), (0,), (1e-4, 1e-5)),
    Probe("ad_batched_dot", loss_batched_dot,
          _normal(((28, 32, 128), 0.1), ((28, 128, 128), 0.1)), (0, 1),
          (1e-3, 1e-4)),
    Probe("ad_wgrad2d", loss_wgrad2d,
          _normal(((32, 60, 128), 0.1), ((32, 60, 256), 0.1)), (0,),
          (1e-3, 1e-4)),
    Probe("ad_softmax_ce", loss_softmax_ce, _ce_make, (0,), (1e-4, 1e-6)),
    # The JAX kernel's arguments are (x, w1, w2, onehot); the loss takes
    # (w1, w2, x, onehot) and differentiates w1 and w2.
    Probe("ad_full_chain",
          lambda ops, x, w1, w2, oh: loss_full_chain(ops, w1, w2, x, oh),
          _chain_make, (1, 2), (1e-3, 1e-4)),
]

BY_NAME: Dict[str, Probe] = {p.name: p for p in PROBES}


def run_probe(probe: Probe, device, seed: int = 0) -> Dict:
    """One probe on ``device``: the hand-written backward against
    ``torch.autograd`` of the plain body; a failure is recorded."""
    gen = torch.Generator(device).manual_seed(seed)
    try:
        inputs = probe.make(gen, torch.device(device))
        err = compare(probe.grads(*inputs),
                      probe.grads(*inputs, ops=PLAIN_OPS), probe.tol)
        return {"probe": probe.name, "family": "autodiff", "status": "PASS",
                "max_abs_err": err}
    except Exception as e:  # noqa: BLE001 - record and continue
        msg = "".join(traceback.format_exception_only(type(e), e)).strip()
        return {"probe": probe.name, "family": "autodiff", "status": "FAIL",
                "detail": msg[:400]}


def run_probes(device="cuda", seed: int = 0, probes=PROBES) -> List[Dict]:
    """Every probe on ``device``; one result per probe."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the plain "
                           "versions")
    return [run_probe(p, device, seed) for p in probes]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return report(run_probes(args.device, args.seed), "ad_in_kernel")


if __name__ == "__main__":
    sys.exit(main())
