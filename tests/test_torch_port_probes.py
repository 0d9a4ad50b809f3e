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

The contraction kernel's split over k is planned in Python from the shape
alone (``plan_splits``); its cases check that the chunks cover k once, in
order, and that the probes' small-tile shapes fill the card.

The ``cuda`` cases hold every probe's kernel to its plain version, the
contraction at every K5/K6 shape and at ragged, split and unsplit shapes
to ``contract_plain`` and to itself bitwise, and the Philox kernel bitwise
to the plain generator; they skip without a card.
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
from multimodal_fl_security_tpu_torch.ops.probe_contract import (
    TILE,
    TILE_K,
    contract,
    contract_plain,
    plan_splits,
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


#: (batch, m, n, k) of every contraction the K5 and K6 probes launch, the
#: least number of blocks each must run on, and ragged shapes
CONTRACT_SHAPES = {
    "dot_3d_2d": ((1, 1792, 256, 128), 132),
    "einsum_brl_rlf": ((1, 32, 128, 14336), 64),
    "batched_dot": ((56, 32, 128, 256), 132),
    "outer_wgrad": ((1, 14336, 128, 32), 132),
    "wgrad_2d": ((1, 128, 256, 1792), 128),
    "outer_wgrad_chunked": ((7, 2048, 128, 32), 132),
    "dgrad_rhs_T_2d": ((1, 32, 128, 128), 1),
    "dgrad_rhs_T_big": ((1, 1792, 1152, 256), 132),
    "dgrad_rhs_T_batched": ((28, 32, 64, 128), 132),
    "ad_dot_rl": ((1, 32, 128, 3584), 128),
    "ad_dot_rl_dx": ((28, 32, 128, 128), 128),
    "ad_dot_rl_dw": ((28, 128, 128, 32), 128),
    "ad_wgrad2d": ((1, 128, 256, 1920), 128),
    "ad_wgrad2d_da": ((1, 1920, 128, 256), 132),
    "ad_chain_dot": ((1, 1920, 256, 128), 132),
    "ragged": ((1, 33, 65, 1000), 64),
    "ragged_batched": ((3, 33, 65, 1000), 128),
    "short_k": ((2, 70, 10, 7), 1),
}


@pytest.mark.parametrize("name", list(CONTRACT_SHAPES))
def test_plan_splits_covers_k_once_in_order(name):
    (batch, m, n, k), min_blocks = CONTRACT_SHAPES[name]
    splits, chunk = plan_splits(batch, m, n, k)
    assert plan_splits(batch, m, n, k) == (splits, chunk)
    bounds = [(s * chunk, min(k, (s + 1) * chunk)) for s in range(splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)  # none empty
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if splits > 1:
        assert chunk % TILE_K == 0
    tiles = batch * -(-m // TILE) * -(-n // TILE)
    assert tiles * splits >= min_blocks
    assert batch * splits <= 65535  # the grid's z limit


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


def contract_operands(gen, name, dtype):
    """(a, b) of one CONTRACT_SHAPES case as the probes lay them out: the
    transposed, permuted, two-axis-k and broadcast views they pass."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    if name == "einsum_brl_rlf":
        return randn(32, 56, 256)[None], randn(56, 256, 128)[None]
    if name in ("outer_wgrad", "outer_wgrad_chunked"):
        a = randn(32, 56, 256).permute(1, 2, 0).reshape(1, 14336, 32)
        g = randn(32, 128)[None]
        if name == "outer_wgrad":
            return a, g
        return a.view(7, 2048, 32), g.expand(7, 32, 128)
    if name in ("wgrad_2d", "ad_wgrad2d"):
        r = 1792 if name == "wgrad_2d" else 1920
        return randn(r, 128).T[None], randn(r, 256)[None]
    if name.startswith("dgrad_rhs_T") or name == "ad_wgrad2d_da":
        (batch, m, n, k), _ = CONTRACT_SHAPES[name]
        return randn(batch, m, k), randn(batch, n, k).transpose(1, 2)
    if name == "ad_dot_rl":
        return randn(28, 32, 128).permute(1, 0, 2)[None], randn(28, 128,
                                                                 128)[None]
    if name == "ad_dot_rl_dx":
        return (randn(32, 128)[None].expand(28, 32, 128),
                randn(28, 128, 128).transpose(1, 2))
    if name == "ad_dot_rl_dw":
        return (randn(28, 32, 128).transpose(1, 2),
                randn(32, 128)[None].expand(28, 32, 128))
    (batch, m, n, k), _ = CONTRACT_SHAPES[name]
    if name == "ragged_batched":  # b's batch stride 0
        return randn(batch, m, k), randn(k, n)[None].expand(batch, k, n)
    return randn(batch, m, k), randn(batch, k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(CONTRACT_SHAPES))
def test_contract_kernel_matches_plain(name, dtype):
    """Every K5/K6 contraction shape and layout, ragged shapes, a batch
    stride of 0, split (S > 1) and unsplit: within the probes' tolerance of
    contract_plain (bf16 operands: their products are exact in f32, so the
    f32 tolerance), and two calls bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(8)
    a, b = contract_operands(gen, name, dtype)
    shape = (a.shape[0], a.shape[1], b.shape[-1], b.shape[-2] if a.dim() == 3
             else a.shape[2] * a.shape[3])
    assert shape == CONTRACT_SHAPES[name][0]
    before = contract.launches
    got, again = contract(a, b), contract(a, b)
    want = contract_plain(a, b)
    torch.cuda.synchronize()
    assert contract.launches == before + 2
    assert contract.plans[shape] == plan_splits(*shape)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got, again)
    rtol, atol = port.F32_TOL
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
