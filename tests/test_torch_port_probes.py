"""The port's Mosaic probe set (K5) against the JAX probes' kernel bodies.

Each JAX probe of ``benchmarks/mosaic_probe.py`` runs with the module's
``pl`` swapped for a namespace whose ``pallas_call`` runs in Pallas
interpret mode and records its concrete inputs and outputs (under
``jax.disable_jit()``); no JAX file changes. The recorded inputs go to the
port's probe of the same name on the CPU, whose output is held to the
recorded one at the probe's tolerance: layout probes bitwise, f32
contractions rtol 2e-4 / atol 2e-3 (or the JAX probe's own where looser),
bf16 contractions rtol 2e-2 / atol 2e-1, reductions the JAX probe's own.

``prng_replay`` has no CPU lowering in JAX (``prng_seed``); its case holds
the plain Philox4x32-10 to the Random123 known answers and checks that a
reseed reproduces the bits.

The ``cuda`` cases hold every probe's kernel to its plain version and the
Philox kernel bitwise to the plain generator; they skip without a card.
"""

import functools
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodal_fl_security_tpu_torch.benchmarks import mosaic_probe as port
from multimodal_fl_security_tpu_torch.ops.philox import (
    philox4x32_plain,
    philox_bits_plain,
    philox_draw_twice,
)

REPO = Path(__file__).resolve().parent.parent

#: Random123's known answers for Philox4x32-10: (counter, key, result)
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@functools.cache
def jax_probes(name):
    """``benchmarks/<name>.py`` of the JAX package's repo, loaded once."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def record(monkeypatch, module, short):
    """Run the JAX probe named ``short`` in interpret mode; returns the
    [(inputs, outputs)] of its pallas_calls and what it raised, if
    anything."""
    import jax
    from jax.experimental import pallas as pl

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
    return records, error


def to_torch(a):
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def test_probe_names_match_the_jax_set():
    module = jax_probes("mosaic_probe")
    names = [inspect.getclosurevars(v).nonlocals["name"].split(":")[0]
             for v in vars(module).values() if getattr(v, "_probe", False)]
    assert names == [p.name for p in port.PROBES]


def check_prng_replay():
    for counter, key, want in KNOWN_ANSWERS:
        got = philox4x32_plain(torch.tensor(counter, dtype=torch.int64), key)
        assert [int(v) for v in got] == list(want)
    eq, a, b = port.BY_NAME["prng_replay"].kernel(
        torch.tensor([1234], dtype=torch.int32))
    assert bool((eq == 1.0).all()) and torch.equal(a, b)
    assert 0 <= int(a.min()) and int(a.max()) < 2 ** 32
    # The draw is the plain generator's at (c, s, stream) = (0, 0, 0).
    assert torch.equal(a, philox_bits_plain(1234, (1, 32, 256), 0, 0)[0])


@pytest.mark.parametrize("name", [p.name for p in port.PROBES])
def test_probe_matches_the_jax_kernel_body(monkeypatch, name):
    if name == "prng_replay":
        check_prng_replay()
        return
    records, error = record(monkeypatch, jax_probes("mosaic_probe"), name)
    assert error is None, error
    assert len(records) == 1
    inputs, out = records[0]
    probe = port.BY_NAME[name]
    got = probe.kernel(*[to_torch(a) for a in inputs])
    want = tuple(to_torch(o) for o in (out if isinstance(out, (list, tuple))
                                       else (out,)))
    err = port.compare(got, want if len(want) > 1 else want[0], probe.tol)
    print(f"{name}: max|port - JAX| {err:.3g}")  # shown with pytest -s


def test_draws_differ_by_seed_step_stream_and_client():
    base = philox_bits_plain(7, (2, 4, 6), 3, 0)
    assert not torch.equal(base[0], base[1])
    for args in ((8, 3, 0), (7, 4, 0), (7, 3, 1)):
        assert not torch.equal(base, philox_bits_plain(args[0], (2, 4, 6),
                                                       args[1], args[2]))
    # A ragged width (B*F not a multiple of 4) is the prefix of the words.
    wide = philox_bits_plain(7, (2, 1, 24), 3, 0)
    assert torch.equal(base.reshape(2, -1), wide.reshape(2, -1))


# ---------------------------------------------------------------- CUDA

@pytest.mark.cuda
@pytest.mark.parametrize("name", [p.name for p in port.PROBES])
def test_probe_kernel_matches_plain_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = port.run_probe(port.BY_NAME[name], "cuda")
    assert result["status"] == "PASS", result


@pytest.mark.cuda
@pytest.mark.parametrize("shape,step,stream", [
    ((1, 32, 256), 0, 0), ((3, 5, 7), 9, 1), ((100, 32, 3136), 37, 0)])
def test_philox_kernel_is_bitwise_the_plain_generator(shape, step, stream):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seed = 0x1234_5678_9ABC
    a, b, eq = philox_draw_twice(seed, shape, step, stream, "cuda")
    want = philox_bits_plain(seed, shape, step, stream, "cuda")
    assert torch.equal(a, want) and torch.equal(b, want)
    assert bool((eq == 1.0).all())
