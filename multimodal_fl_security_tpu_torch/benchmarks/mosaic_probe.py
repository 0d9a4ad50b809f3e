"""The Mosaic probe set (K5) on hand-written Hopper kernels.

Counterpart of ``benchmarks/mosaic_probe.py`` at the repo root: the same 28
probes, by the same names, shapes and tolerances, each computing what the
JAX probe's kernel body computes, through the port's probe kernels
(``ops/probe_layout.py``, ``ops/probe_contract.py``, ``ops/probe_reduce.py``,
``ops/philox.py``). Each probe is held to its plain PyTorch version
(``torch.roll``, slicing, ``permute``, ``expand``, ``torch.einsum``, sums)
on the same inputs: exactly for the layout, generator and carried-sum
probes, within the JAX probe's tolerance for the others. Inputs are made
from a seed; the arange probes use the JAX probes' own aranges.

Each :class:`Probe`'s ``kernel`` takes the JAX kernel's arguments in their
order and shapes and returns its output(s), so the CPU tests feed it the
JAX probes' recorded inputs. ``prng_replay`` draws, reseeds and draws again
on Philox4x32-10 (the TPU's generator has no counterpart) and also returns
both draws' raw bits.

Run on the card::

    python -m multimodal_fl_security_tpu_torch.benchmarks.mosaic_probe

prints one line per probe and a JSON summary; exits non-zero if a probe
fails. ``--device cpu`` runs every kernel's plain version instead.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import traceback
from typing import Any, Callable, Dict, List

import torch

from multimodal_fl_security_tpu_torch.ops.philox import (
    philox_draw_twice,
    philox_draw_twice_plain,
)
from multimodal_fl_security_tpu_torch.ops.probe_contract import contract
from multimodal_fl_security_tpu_torch.ops.probe_layout import (
    Axis,
    gather,
    identity_axes,
    roll,
)
from multimodal_fl_security_tpu_torch.ops.probe_reduce import (
    block_fold,
    carry_sum,
    masked_ce,
    max2,
    scalar_accum,
)

#: f32 contractions (the JAX probes' own, where none is looser)
F32_TOL = (2e-4, 2e-3)
#: bf16 operands
BF16_TOL = (2e-2, 2e-1)


@dataclasses.dataclass(frozen=True)
class Probe:
    """One probe: its inputs from a generator, the kernel path, the plain
    version, and the tolerance (rtol, atol); (0, 0) means bitwise."""

    name: str
    family: str
    make: Callable[[torch.Generator, torch.device], tuple]
    kernel: Callable[..., Any]
    plain: Callable[..., Any]
    tol: tuple = (0.0, 0.0)


def _arange(*shape):
    def make(gen, device):
        n = 1
        for s in shape:
            n *= s
        return (torch.arange(n, dtype=torch.float32,
                             device=device).reshape(shape),)
    return make


def _randn(*shapes, dtype=torch.float32):
    def make(gen, device):
        return tuple(torch.randn(s, generator=gen, device=device).to(dtype)
                     for s in shapes)
    return make


def _lane_write_plain(w):
    out = torch.zeros((128, 256), dtype=w.dtype, device=w.device)
    out[:32, :64] = w
    return out


def _iota_plain(x):
    rows = torch.arange(60, device=x.device)[None, :, None] % 4 < 2
    lanes = torch.arange(128, device=x.device)[None, None, :] >= 32
    return torch.where(rows & lanes, x, torch.zeros((), device=x.device))


def _fold_plain(d):
    return sum(d[32 * b:32 * b + 32, 64 * b:64 * b + 64] for b in range(4))


def _softmax_make(gen, device):
    x = torch.randn((32, 128), generator=gen, device=device)
    lab = torch.randint(0, 10, (32, 1), generator=gen, device=device,
                        dtype=torch.int32)
    return x, lab


def _softmax_kernel(x, lab):
    nll, _ = masked_ce(x, labels=lab, nvalid=10)
    return nll[:, None].expand(32, 128)


def _softmax_plain(x, lab):
    lanes = torch.arange(128, device=x.device)
    logits = torch.where(lanes < 10, x, torch.tensor(-1e30, device=x.device))
    lse = torch.logsumexp(logits, dim=1)
    nll = lse - logits.gather(1, lab.long()).squeeze(1)
    return nll[:, None].expand(32, 128)


def _prng_make(gen, device):
    return (torch.tensor([1234], dtype=torch.int32, device=device),)


def _prng_kernel(seed):
    a, b, eq = philox_draw_twice(int(seed[0]), (1, 32, 256), device=seed.device)
    return eq[0], a[0], b[0]


def _prng_plain(seed):
    a, b, eq = philox_draw_twice_plain(int(seed[0]), (1, 32, 256),
                                       device=seed.device)
    return eq[0], a[0], b[0]


def _outer(a):
    """[32, 56, 256] -> the [1, 56*256, 32] view: m = (r, l), k = batch."""
    return a.permute(1, 2, 0).reshape(1, 56 * 256, 32)


PROBES: List[Probe] = [
    Probe("split_lanes_128", "layout", _arange(32, 7680),
          lambda x: gather(x, [Axis(32, 0), Axis(60, 1, scale=128),
                               Axis(128, 1)]),
          lambda x: x.reshape(32, 60, 128).clone()),
    Probe("merge_major_sublane", "layout", _arange(32, 60, 128),
          lambda x: gather(x, identity_axes(x)).view(1920, 128),
          lambda x: x.reshape(1920, 128).clone()),
    Probe("row_roll", "layout", _arange(32, 60, 128),
          lambda x: roll(x, 59, 1), lambda x: torch.roll(x, 59, 1)),
    Probe("lane_roll_32", "layout", _arange(32, 60, 128),
          lambda x: roll(x, 96, 2), lambda x: torch.roll(x, 96, 2)),
    Probe("lane_roll_64_2d", "layout", _arange(128, 256),
          lambda x: roll(x, 64, 1), lambda x: torch.roll(x, 64, 1)),
    Probe("iota_mask_3d", "layout",
          lambda gen, device: (torch.ones((32, 60, 128), device=device),),
          lambda x: gather(x, [Axis(32, 0), Axis(60, 1, keep=(4, 0, 2)),
                               Axis(128, 2, keep=(128, 32, 128))]),
          _iota_plain),
    Probe("dot_3d_2d", "contract", _randn((32, 56, 128), (128, 256)),
          lambda a, b: contract(a.reshape(1, 1792, 128),
                                b[None]).view(32, 56, 256),
          lambda a, b: torch.einsum("brk,kn->brn", a, b), F32_TOL),
    Probe("einsum_brl_rlf", "contract", _randn((32, 56, 256), (56, 256, 128)),
          lambda a, w: contract(a[None], w[None])[0],
          lambda a, w: torch.einsum("brl,rlf->bf", a, w), F32_TOL),
    Probe("batched_dot", "contract", _randn((56, 32, 256), (56, 256, 128)),
          contract, lambda a, w: torch.einsum("sbl,slf->sbf", a, w), F32_TOL),
    Probe("outer_wgrad", "contract", _randn((32, 56, 256), (32, 128)),
          lambda a, g: contract(_outer(a), g[None]).view(56, 256, 128),
          lambda a, g: torch.einsum("brl,bf->rlf", a, g), F32_TOL),
    Probe("wgrad_2d", "contract", _randn((1792, 128), (1792, 256)),
          lambda a, g: contract(a.T[None], g[None])[0],
          lambda a, g: torch.einsum("rk,rn->kn", a, g), (2e-3, 2e-1)),
    Probe("lane_slice_read", "layout", _arange(128, 256),
          lambda x: gather(x, [Axis(32, 0), Axis(64, 1)]),
          lambda x: x[0:32, 0:64].clone()),
    Probe("lane_slice_write", "layout", _arange(32, 64),
          lambda w: gather(w, [Axis(128, 0, limit=32),
                               Axis(256, 1, limit=64)]),
          _lane_write_plain),
    Probe("selector_matmul_fold", "reduce", _randn((128, 256)),
          lambda d: block_fold(d, 32, 64, 4), _fold_plain, (1e-6, 0.0)),
    Probe("major_transpose", "layout", _randn((32, 56, 256)),
          lambda x: gather(x, [Axis(56, 1), Axis(32, 0), Axis(256, 2)]),
          lambda x: x.permute(1, 0, 2).contiguous()),
    Probe("prng_replay", "prng", _prng_make, _prng_kernel, _prng_plain),
    Probe("grid_scratch_persist", "reduce", _arange(4, 5, 8, 128),
          lambda d: carry_sum(d.reshape(4, 5, 1024)).view(4, 8, 128),
          lambda d: d.sum(dim=1)),
    Probe("softmax_masked", "reduce", _softmax_make, _softmax_kernel,
          _softmax_plain, (3e-4, 3e-4)),
    Probe("bf16_mixed", "contract",
          _randn((32, 56, 128), (128, 256), dtype=torch.bfloat16),
          lambda a, b: contract(a.reshape(1, 1792, 128),
                                b[None]).view(32, 56, 256),
          lambda a, b: torch.einsum("brk,kn->brn", a.float(), b.float()),
          BF16_TOL),
    Probe("bf16_default_prec", "contract",
          _randn((32, 56, 128), (128, 256), dtype=torch.bfloat16),
          lambda a, b: contract(a.reshape(1, 1792, 128),
                                b[None]).view(32, 56, 256),
          lambda a, b: torch.einsum("brk,kn->brn", a.float(), b.float()),
          BF16_TOL),
    Probe("outer_wgrad_chunked", "contract", _randn((32, 56, 256), (32, 128)),
          lambda a, g: contract(_outer(a).view(7, 8 * 256, 32),
                                g[None].expand(7, 32, 128)
                                ).view(56, 256, 128),
          lambda a, g: torch.einsum("brl,bf->rlf", a, g), F32_TOL),
    Probe("dgrad_rhs_T_2d", "contract", _randn((32, 128), (128, 128)),
          lambda g, w: contract(g[None], w.T[None])[0],
          lambda g, w: torch.einsum("bk,nk->bn", g, w), F32_TOL),
    Probe("dgrad_rhs_T_big", "contract", _randn((1792, 256), (1152, 256)),
          lambda g, w: contract(g[None], w.T[None])[0],
          lambda g, w: torch.einsum("bk,nk->bn", g, w), (2e-3, 2e-1)),
    Probe("dgrad_rhs_T_batched", "contract",
          _randn((28, 32, 128), (28, 64, 128)),
          lambda g, w: contract(g, w.transpose(1, 2)),
          lambda g, w: torch.einsum("rbf,rlf->rbl", g, w), F32_TOL),
    Probe("broadcast_major", "layout", _arange(32, 128),
          lambda x: gather(x, [Axis(28), Axis(32, 0), Axis(128, 1)]),
          lambda x: x[None].expand(28, 32, 128).clone()),
    Probe("sublane_pool_reshape", "reduce", _randn((32, 56, 256)),
          lambda x: max2(x.view(32, 7, 2, 4, 256)[:, :, 0],
                         x.view(32, 7, 2, 4, 256)[:, :, 1]
                         ).view(32, 28, 256),
          lambda x: x.view(32, 7, 2, 4, 256).amax(dim=2).reshape(32, 28, 256)),
    Probe("lane_slice_64", "layout", _arange(32, 28, 256),
          lambda x: gather(x, [Axis(32, 0), Axis(28, 1),
                               Axis(2, 2, scale=128), Axis(64, 2)]
                           ).view(32, 28, 128),
          lambda x: torch.cat([x[:, :, 0:64], x[:, :, 128:192]], dim=2)),
    Probe("scalar_accum_smem", "reduce", _arange(5, 8, 128),
          lambda d: scalar_accum(d.reshape(5, 1024)),
          lambda d: d.sum().reshape(1), (1e-6, 0.0)),
]

BY_NAME: Dict[str, Probe] = {p.name: p for p in PROBES}


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def compare(got, want, tol) -> float:
    """max|got - want| over the outputs; raises past the tolerance
    ``(rtol, atol)``, or unless bitwise equal when both are 0."""
    rtol, atol = tol
    err = 0.0
    for g, w in zip(as_tuple(got), as_tuple(want), strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        e = float((g.double() - w.double()).abs().max())
        err = max(err, e)
        if rtol == atol == 0.0:
            if not torch.equal(g, w):
                raise AssertionError(f"not bitwise equal (max err {e})")
        else:
            torch.testing.assert_close(g.double(), w.double(), rtol=rtol,
                                       atol=atol)
    return err


def run_probe(probe: Probe, device, seed: int = 0) -> Dict:
    """One probe on ``device``: the kernel path against the plain version;
    a failure is recorded, not raised, as the JAX harness does."""
    gen = torch.Generator(device).manual_seed(seed)
    try:
        inputs = probe.make(gen, torch.device(device))
        err = compare(probe.kernel(*inputs), probe.plain(*inputs), probe.tol)
        return {"probe": probe.name, "family": probe.family,
                "status": "PASS", "max_abs_err": err}
    except Exception as e:  # noqa: BLE001 - record and continue
        msg = "".join(traceback.format_exception_only(type(e), e)).strip()
        return {"probe": probe.name, "family": probe.family,
                "status": "FAIL", "detail": msg[:400]}


def run_probes(device="cuda", seed: int = 0, probes=PROBES) -> List[Dict]:
    """Every probe on ``device``; one result per probe."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for the plain "
                           "versions")
    return [run_probe(p, device, seed) for p in probes]


def report(results: List[Dict], title: str) -> int:
    """Print one line per probe and a JSON summary; the exit code (1 if
    any probe failed)."""
    for r in results:
        line = f"{r['status']} {r['probe']}"
        line += (f" (max abs err {r['max_abs_err']:.3g})"
                 if r["status"] == "PASS" else f": {r['detail']}")
        print(line)
    passed = sum(r["status"] == "PASS" for r in results)
    print(json.dumps({"probes": title, "passed": passed,
                      "total": len(results), "results": results}))
    return 0 if passed == len(results) else 1


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return report(run_probes(args.device, args.seed), "mosaic")


if __name__ == "__main__":
    sys.exit(main())
