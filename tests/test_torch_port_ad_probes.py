"""The port's autodiff probe set (K6) against the JAX probes' in-kernel
``jax.grad``.

Each JAX probe of ``benchmarks/ad_in_kernel_probe.py`` runs with the
module's ``pl`` swapped for a namespace whose ``pallas_call`` runs in Pallas
interpret mode and records its concrete inputs and outputs (under
``jax.disable_jit()``); no JAX file changes. The recorded inputs go to the
port's probe of the same name on the CPU twice: through the hand-written
backward passes (``ops/probe_autograd.py``, each kernel's plain version)
and through ``torch.autograd`` of the plain body. Both are held to the
gradients the JAX kernel computed, at the JAX probe's tolerance.

``ad_full_chain``'s JAX probe fails its own check: its reference
``loss_ref`` rolls the shift-32 tap by -32, its kernel body by +32. One
case pins that finding. The ``cuda`` cases hold the hand-written backward
to ``torch.autograd`` of the plain body on the card; they skip without one.
"""

import functools
import importlib.util
import inspect
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.benchmarks import (
    ad_in_kernel_probe as port,
)
from multimodal_fl_security_tpu_torch.benchmarks.mosaic_probe import compare
from multimodal_fl_security_tpu_torch.ops.probe_autograd import (
    KERNEL_OPS,
    PLAIN_OPS,
)

REPO = Path(__file__).resolve().parent.parent


@functools.cache
def jax_probes():
    """``benchmarks/ad_in_kernel_probe.py``, loaded once."""
    spec = importlib.util.spec_from_file_location(
        "jax_ad_in_kernel_probe", REPO / "benchmarks" / "ad_in_kernel_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record(monkeypatch, short):
    """Run the JAX probe named ``short`` in interpret mode; returns the
    [(inputs, outputs)] of its pallas_calls and what it raised, if
    anything."""
    import jax
    from jax.experimental import pallas as pl

    module = jax_probes()
    records = []

    class Recording:
        def __getattr__(self, attr):
            return getattr(pl, attr)

        @staticmethod
        def pallas_call(kernel, *args, **kwargs):
            call = pl.pallas_call(kernel, *args, interpret=True, **kwargs)

            def run(*inputs):
                out = call(*inputs)
                records.append((inputs, out))
                return out
            return run

    monkeypatch.setattr(module, "pl", Recording())
    fn = next(v for v in vars(module).values()
              if getattr(v, "_probe", False)
              and inspect.getclosurevars(v).nonlocals["name"].split(":")[0]
              == short)
    error = None
    with jax.disable_jit():
        try:
            fn.__wrapped__()
        except Exception as e:  # noqa: BLE001 - the caller decides
            error = e
    assert len(records) == 1
    inputs, out = records[0]
    outs = tuple(out) if isinstance(out, (list, tuple)) else (out,)
    return ([torch.from_numpy(np.array(a)) for a in inputs],
            tuple(torch.from_numpy(np.array(o)) for o in outs), error)


def test_probe_names_match_the_jax_set():
    names = [inspect.getclosurevars(v).nonlocals["name"].split(":")[0]
             for v in vars(jax_probes()).values()
             if getattr(v, "_probe", False)]
    assert names == [p.name for p in port.PROBES]


@pytest.mark.parametrize("name", [p.name for p in port.PROBES])
def test_gradients_match_jax_in_kernel_grad(monkeypatch, name):
    inputs, want, error = record(monkeypatch, name)
    if name != "ad_full_chain":  # its own check fails: see the next test
        assert error is None, error
    probe = port.BY_NAME[name]
    want = want if len(want) > 1 else want[0]
    for ops in (KERNEL_OPS, PLAIN_OPS):
        err = compare(probe.grads(*inputs, ops=ops), want, probe.tol)
        print(f"{name}: max|port - JAX| {err:.3g}")  # shown with pytest -s


def test_full_chain_reference_rolls_the_other_way(monkeypatch):
    """JAX's ``loss_ref`` takes ``jnp.roll(x, -32, 2)`` where the kernel
    body's ``droll(x, 32, 2)`` is ``np.roll(x, +32)``: its probe fails
    against its own kernel, and the port follows the kernel body."""
    inputs, (g1, g2), error = record(monkeypatch, "ad_full_chain")
    assert isinstance(error, AssertionError)
    assert "Not equal to tolerance" in str(error)
    probe = port.BY_NAME["ad_full_chain"]
    ref_ops = types.SimpleNamespace(**{
        **vars(PLAIN_OPS), "roll": lambda x, s, d: torch.roll(x, -s, d)})
    r1, r2 = probe.grads(*inputs, ops=ref_ops)
    assert float((r1 - g1).abs().max()) > 1e-3  # loss_ref's gradient
    compare(probe.grads(*inputs, ops=PLAIN_OPS), (g1, g2), probe.tol)


# ---------------------------------------------------------------- CUDA

@pytest.mark.cuda
@pytest.mark.parametrize("name", [p.name for p in port.PROBES])
def test_hand_written_backward_matches_autograd_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = port.run_probe(port.BY_NAME[name], "cuda")
    assert result["status"] == "PASS", result
