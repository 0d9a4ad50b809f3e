"""Port ViT-B/16 against the plain reference and an independent oracle, on
the CPU.

The full ViT-B/16 is held to its published parameter count and to the
benchmark's configuration file (layout only, no forward). The arithmetic is
compared at a small size: 32 x 32 images cut into 8 x 8 patches (17
tokens), width 64, 4 heads, depth 2, MLP 256, 10 classes, C = 3 clients of
B = 4 images, distinct parameters a client and the same dropout masks on
every side. One block is also held to ``torch.nn.TransformerEncoderLayer``
(pre-LN, exact GELU, eps 1e-6, no dropout) with the client's weights copied
in: an oracle independent of both the port and the reference.

Tolerances (f32 on every side, each summing its products, norms and softmax
in another order; measured here ~5e-7 of the largest logit and ~1e-6 of
each leaf's largest gradient between the port and the reference): logits
within 2e-5 of the largest logit, each leaf's gradient within 2e-5 of its
largest element. Rounding every product's operands to TF32
(``reference/precision.py``, the benchmark's control) moves them ~1e-3, so
it fails both; the test checks that too.
"""

from __future__ import annotations

import json
import types

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.profiler import ProfilerActivity, profile

from multimodal_fl_security_tpu_torch.attacks import get_attack
from multimodal_fl_security_tpu_torch.data.stacking import ClientData
from multimodal_fl_security_tpu_torch.defenses import get_defense
from multimodal_fl_security_tpu_torch.models import create_model, vit
from multimodal_fl_security_tpu_torch.ops.client_dropout import RoundDraws
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    kernel_step_takes,
)
from multimodal_fl_security_tpu_torch.rounds.engine import (
    RoundEngine,
    TrainSpec,
    cross_entropy,
)
from multimodal_fl_security_tpu_torch.utils import tracing
from torch_bench import correctness, federation
from torch_bench.cell import CHECKOUT, load_cell
from torch_bench.metrics import _program_spans
from torch_bench.reference import round as ref_round
from torch_bench.reference.models import vit_b16 as ref_model
from torch_bench.run import first_rounds
from torch_bench.trace import Trace

C, B, HW, K, RATE = 3, 4, 32, 10, 0.3
WIDTHS = dict(patch_size=8, depth=2, num_heads=4, mlp_dim=256, eps=1e-6)
WIDTH = 64
#: f32 against f32 in another summation order (see the module docstring)
TOL = 2e-5
CELL = "vit_b16_trimmed_alie_c10_f32"
CONTROL = ("patch_embed.proj", "attn.qkv", "attn.qk", "attn.pv", "attn.proj",
           "mlp.fc1", "mlp.fc2", "head")


def small_model():
    return vit.ViT(num_classes=K, hidden_dim=WIDTH, image_size=(HW, HW),
                   dropout_rates=(RATE,), **WIDTHS)


def small_config(model):
    """The reference's configuration keys for ``model``."""
    return {"model": "vit_b16", "in_channels": 3, "image_size": [HW, HW],
            "num_classes": K, "hidden_dim": WIDTH, "dropout_rates": [RATE],
            **WIDTHS, "param_count": model.layout(3).dim,
            "leaves": [[n, list(s)] for n, s in model.layout(3).entries]}


@pytest.fixture(scope="module")
def case():
    """Distinct parameters a client: the port's initial draw plus noise, so
    that LayerNorm scales, biases, the class token and the position
    embeddings all differ from their defaults and between clients."""
    model = small_model()
    gen = torch.Generator().manual_seed(1)
    params = torch.stack([model.init_params(3, gen) for _ in range(C)])
    params += 0.05 * torch.randn(params.shape, generator=gen)
    images = torch.randn((C, B, 3, HW, HW), generator=gen)
    labels = torch.randint(0, K, (C, B), generator=gen)
    mask = torch.tensor([[1.0] * B] * (C - 1) + [[1.0, 1.0, 1.0, 0.0]])
    keep = torch.rand((C, B, WIDTH),
                      generator=torch.Generator().manual_seed(7)) < 1 - RATE
    return dict(model=model, params=params, images=images, labels=labels,
                mask=mask, keep=keep)


def test_full_vit_b16_matches_the_configuration():
    model = create_model("vit_b16", num_classes=200, hidden_dim=768,
                         image_size=(224, 224), dropout_rates=(0.3,),
                         dtype=torch.float32)
    layout = model.layout(3)
    assert len(layout.entries) == 152 and layout.dim == 85_952_456
    assert (model.tokens, model.num_heads, model.mlp_dim, model.depth) == \
        (197, 12, 3072, 12)
    config = load_cell(CELL).config
    assert [(n, tuple(s)) for n, s in config["leaves"]] == layout.entries
    assert config["param_count"] == layout.dim
    assert (config["hidden_dim"], config["patch_size"], config["depth"],
            config["num_heads"], config["mlp_dim"], config["eps"]) == \
        (768, 16, 12, 12, 3072, 1e-6)
    assert tuple(config["control"]["layers"]) == CONTROL
    assert not config["allow_tf32_matmul"] and not config["allow_tf32_cudnn"]
    # timm's names: the qkv weight holds q | k | v of 12 heads of 64
    shapes = dict(layout.entries)
    assert shapes["blocks.11.attn.qkv.weight"] == (2304, 768)
    assert shapes["pos_embed"] == (1, 197, 768)
    assert layout.entries[-1] == ("head.bias", (200,))


def test_factory_checks_its_widths():
    with pytest.raises(ValueError, match="width is 768"):
        create_model("vit_b16", hidden_dim=1024)
    with pytest.raises(ValueError, match="one dropout rate"):
        create_model("vit_b16", dropout_rates=(0.25, 0.5))
    with pytest.raises(ValueError, match="float32"):
        create_model("vit_b16", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="patches"):
        create_model("vit_b16", image_size=(200, 200))
    model = small_model()
    flat = model.init_params(3, torch.Generator().manual_seed(0))
    for name, v in model.layout(3).views(flat).items():
        if name == "pos_embed":  # timm's N(0, 0.02^2), truncated at 2 sigma
            assert 0 < v.abs().max() <= 2 * vit.POS_STD
        elif name == "cls_token" or name.endswith(".bias"):
            assert torch.equal(v, torch.zeros_like(v)), name
        elif v.dim() == 1:  # LayerNorm scales
            assert torch.equal(v, torch.ones_like(v)), name
        else:  # lecun normal, truncated at 2 sigma
            fan_in = v[0].numel()
            assert v.abs().max() <= 2.0 / 0.8796 / fan_in ** 0.5 + 1e-6


def port_loss(case, params):
    logits = case["model"](params, case["images"],
                           RoundDraws(torch.Generator().manual_seed(7),
                                      (RATE,)))
    return logits, cross_entropy(logits, case["labels"], case["mask"])


def reference_loss(case, params, precision=None):
    logits = ref_model.logits(params, case["images"], (case["keep"],),
                              small_config(case["model"]), precision)
    return logits, ref_round.masked_ce(logits, case["labels"], case["mask"],
                                       0.0)


def test_logits_and_gradients_match_the_reference(case):
    layout = case["model"].layout(3)
    runs = {}
    for name, loss_of in (
            ("port", lambda p: port_loss(case, p)),
            ("reference", lambda p: reference_loss(case, p)),
            ("tf32", lambda p: reference_loss(
                case, p, {layer: "tf32" for layer in CONTROL}))):
        params = case["params"].clone().requires_grad_(True)
        logits, losses = loss_of(params)
        losses.sum().backward()
        runs[name] = (logits.detach(), layout.views(params.grad))
    want_logits, want = runs["reference"]
    scale = float(want_logits.abs().max())
    for name, fails in (("port", False), ("tf32", True)):
        logits, grads = runs[name]
        err = float((logits - want_logits).abs().max())
        assert (err > TOL * scale) == fails, (name, err / scale)
        worst = max(float((grads[leaf] - want[leaf]).abs().max()
                          / want[leaf].abs().max()) for leaf in want)
        assert (worst > TOL) == fails, (name, worst)


def test_one_client_on_a_flat_vector_is_its_row_of_the_stack(case):
    model, params = case["model"], case["params"]
    stacked = model(params, case["images"])
    single = model(params[1], case["images"][1])
    assert single.shape == (B, K)
    assert torch.allclose(single, stacked[1], rtol=0, atol=1e-6)


def test_a_block_matches_torch_transformer_encoder_layer(case):
    """Block 0 of each client against ``nn.TransformerEncoderLayer`` with
    the client's weights copied in: outputs and input gradients within
    2e-5 of their largest (measured ~3e-7: the oracle fuses its attention
    and orders its sums otherwise)."""
    model, layout = case["model"], case["model"].layout(3)
    gen = torch.Generator().manual_seed(5)
    h = torch.randn((C, B, model.tokens, WIDTH), generator=gen)
    params = case["params"]
    p = {name: piece.view(C, *shape) for (name, shape), piece in
         zip(layout.entries, params.split(
             [hi - lo for lo, hi in layout.offsets.values()], dim=-1))}
    x = h.clone().requires_grad_(True)
    y = x + model._attention(model._norm(x, p, "blocks.0.norm1"), p,
                             "blocks.0.")
    y = y + model._mlp(model._norm(y, p, "blocks.0.norm2"), p, "blocks.0.")
    up = torch.randn(y.shape, generator=gen)
    (y * up).sum().backward()
    for c in range(C):
        layer = nn.TransformerEncoderLayer(
            WIDTH, WIDTHS["num_heads"], WIDTHS["mlp_dim"], dropout=0.0,
            activation="gelu", layer_norm_eps=1e-6, batch_first=True,
            norm_first=True)
        w = layout.views(params[c])
        with torch.no_grad():
            for mine, theirs in (("attn.qkv", "self_attn.in_proj_"),
                                 ("attn.proj", "self_attn.out_proj."),
                                 ("mlp.fc1", "linear1."),
                                 ("mlp.fc2", "linear2."),
                                 ("norm1", "norm1."), ("norm2", "norm2.")):
                for leaf in ("weight", "bias"):
                    layer.get_parameter(theirs + leaf).copy_(
                        w[f"blocks.0.{mine}.{leaf}"])
        xc = h[c].clone().requires_grad_(True)
        want = layer(xc)
        (want * up[c]).sum().backward()
        scale = float(want.detach().abs().max())
        assert float((y[c].detach() - want.detach()).abs().max()) \
            <= TOL * scale
        gscale = float(xc.grad.abs().max())
        assert float((x.grad[c] - xc.grad).abs().max()) <= TOL * gscale


def small_federation(seed=2**31 + 11):
    model = small_model()
    config = small_config(model)
    mix = {"clients": C, "samples_per_client": 2 * B, "batch_size": B,
           "local_epochs": 1, "learning_rate": 0.001, "momentum": 0.9,
           "weight_decay": 1e-4, "clip_norm": 1.0, "label_smoothing": 0.0,
           "malicious_clients": 1,
           "attack": {"name": "alie", "config": {"num_malicious": 1}},
           "defense": {"name": "trimmed_mean",
                       "config": {"trim_ratio": 0.34}}}
    fed = federation.make_federation(config, mix, seed, "cpu")
    spec = TrainSpec(learning_rate=mix["learning_rate"],
                     momentum=mix["momentum"],
                     weight_decay=mix["weight_decay"],
                     clip_norm=mix["clip_norm"], local_epochs=1,
                     batch_size=mix["batch_size"])
    engine = RoundEngine(
        model, ClientData(arrays={"image": fed.images, "label": fed.labels},
                          mask=fed.mask, counts=fed.counts, num_classes=K),
        spec, attack=get_attack("alie", mix["attack"]["config"]),
        defense=get_defense("trimmed_mean", mix["defense"]["config"]),
        malicious_clients=fed.malicious)
    return engine, fed, config, mix


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_a_round_equals_the_plain_reference_round(seed):
    """One ``RoundEngine`` round against ``reference/round.py``: the same
    batches and masks, so the loss agrees to f32 rounding (rel 1e-5;
    ~1e-7 measured) and the trained rows' changes, leaf by leaf, within
    2e-3 of the larger of the leaf's and the median leaf's change (2e-5 -
    2e-4 measured: a change of ~1e-4 keeps few f32 bits); the new global
    vector's change within 1e-3 of its norm (~2e-5 measured)."""
    engine, fed, config, mix = small_federation(seed)
    got = first_rounds(engine, fed.theta0.clone(),
                       federation.round_generator(fed, "cpu"), 1)
    ref = ref_round.run_rounds(fed, config, mix,
                               federation.round_generator(fed, "cpu"), 1)
    assert got.losses[0] == pytest.approx(ref.losses[0], rel=1e-5)
    assert correctness.worst_leaf_difference(
        got.trained[0] - fed.theta0, ref.trained[0] - fed.theta0,
        config["leaves"]) <= 2e-3
    change = ref.thetas[1] - fed.theta0
    assert float((got.thetas[1] - ref.thetas[1]).norm()) \
        <= 1e-3 * float(change.norm())


def test_the_kernel_trainer_does_not_take_vit():
    spec = TrainSpec(batch_size=32)
    images = torch.zeros((2, 32, 1, 28, 28))
    assert not kernel_step_takes(small_model(), spec, images)


def test_the_reference_imports_neither_jax_nor_the_port():
    text = (CHECKOUT / "torch_bench" / "reference" / "models" /
            "vit_b16.py").read_text()
    imports = [line for line in text.splitlines()
               if line.startswith(("import ", "from "))]
    assert imports and not any("jax" in line or "multimodal" in line
                               for line in imports)


# --- spans ------------------------------------------------------------------

def traced_rounds(engine, fed, rounds, profiled):
    gen = federation.round_generator(fed, "cpu")
    outs, p = [], fed.theta0.clone()

    def go():
        nonlocal p
        for _ in range(rounds):
            p, m = engine.run_round(p, gen)
            outs.append((p, m))

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            go()
    else:
        go()
    return outs


@pytest.fixture
def traced():
    tracing.clear()
    yield small_federation()
    tracing.clear()


def forward_order(depth):
    blocks = [s for _ in range(depth) for s in ("vit_attention", "vit_mlp")]
    return ["vit_embed", *blocks, "vit_head"]


def test_sub_block_spans_nest_under_forward_and_backward(traced):
    engine, fed, _, _ = traced
    traced_rounds(engine, fed, 2, profiled=True)
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    steps = 2
    order = forward_order(WIDTHS["depth"])
    for r in sorted({s.round for s in spans}):
        mine = [s for s in spans if s.round == r]
        for kind, names in (("forward", order),
                            ("backward", [s + ".bwd" for s in
                                          reversed(order)])):
            parents = [s for s in mine if s.name == kind]
            assert len(parents) == steps
            for parent in parents:
                kids = [s for s in mine if s.parent == parent.id]
                assert [s.name for s in kids] == names
                for s in kids:
                    assert by_id[s.parent] is parent and s.round == r
                    assert parent.start_ns <= s.start_ns <= s.end_ns \
                        <= parent.end_ns
                assert all(a.end_ns <= b.start_ns
                           for a, b in zip(kids, kids[1:]))


def test_tracing_leaves_the_round_bitwise_unchanged(traced):
    engine, fed, _, _ = traced
    off = traced_rounds(engine, fed, 1, profiled=False)
    on = traced_rounds(engine, fed, 1, profiled=True)
    assert any(s.name == "vit_mlp.bwd" for s in tracing.spans())
    for (p_off, m_off), (p_on, m_on) in zip(off, on):
        assert torch.equal(p_off, p_on)
        for key in m_off:
            assert torch.equal(m_off[key], m_on[key]), key


def test_the_off_path_registers_no_hook(traced, monkeypatch):
    engine, fed, _, _ = traced
    hooks = []
    original = torch.Tensor.register_hook

    def counted(self, hook):
        hooks.append(hook)
        return original(self, hook)

    monkeypatch.setattr(torch.Tensor, "register_hook", counted)
    traced_rounds(engine, fed, 1, profiled=False)
    assert hooks == [] and tracing.spans() == []
    traced_rounds(engine, fed, 1, profiled=True)
    # a step: the logits, the embedding's output, each block's two
    # residual sums and the patch embedding's weight
    assert len(hooks) == 2 * (3 + 2 * WIDTHS["depth"])


US = 1_000  # ns
#: two profiled rounds in a window of [200, 1000] us
TRACE = Trace(rounds=2, window=(200 * US, 1000 * US), labels=[], device=[])


def span(name, start_us, end_us, device_ms, round=1):
    return tracing.Span(name, id=start_us, parent=None, round=round,
                        start_ns=start_us * US, end_ns=end_us * US,
                        device_ms=device_ms)


SPANS = [span(name, start, start + 5, ms, round=r)
         for r, base in ((0, 0), (1, 300), (2, 600), (3, 1100))
         for k, (name, ms) in enumerate(
             (s, 1.0 + i) for i, s in enumerate(
                 [x for st in vit.SPANS for x in (st, st + ".bwd")]))
         for start in [base + 10 * k]]


@pytest.mark.parametrize("family", vit.SPANS)
def test_span_readers_sum_forward_and_backward_a_round(family, monkeypatch):
    reader = __import__(f"torch_bench.metrics.{family}_device_ms",
                        fromlist=["read"])
    i = vit.SPANS.index(family)
    monkeypatch.setattr(_program_spans, "records", lambda: SPANS)
    # rounds 1 and 2 lie in the window; each holds the family's forward
    # (1 + 2i ms) and backward (2 + 2i ms)
    got = reader.read(types.SimpleNamespace(trace=TRACE))
    assert got == pytest.approx(2 * ((1 + 2 * i) + (2 + 2 * i)) / 2)
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(_program_spans, "records", lambda: [])
    assert reader.read(types.SimpleNamespace(trace=TRACE)) is None


def test_the_cell_is_in_the_benchmark():
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.config_name == "vit_b16_cub200_f32"
    assert [m["name"] for m in cell.per_layer] == [
        f"{s}_device_ms" for s in vit.SPANS]
    # 35.1 GFLOP a forward per image: the dense layers' 33.7, attention's
    # two products 1.4, the patch embedding 0.23
    assert ref_model.forward_flops_per_sample(cell.config) == 35_126_427_648
    mix = cell.traffic
    assert (mix["clients"], mix["samples_per_client"], mix["batch_size"],
            mix["malicious_clients"]) == (10, 48, 16, 2)
    assert mix["kernels"]["sorted_reduce"] == {
        "rows": 10, "trim": 1, "launches_per_round": 1}
    assert set(cell.limits) >= {"loss_gap_1", "rows_gap"}
    config = next(c for c in spec["configs"]
                  if c["name"] == "vit_b16_cub200_f32")
    assert config["reduced"] == ["weights", "images"]
    assert CELL in [w["name"] for w in spec["workloads"]]


def test_the_attention_takes_one_backend_a_device():
    """One backend a device, with no fallback: on CUDA the memory-efficient
    one alone, so that a call it turns down raises rather than running the
    slower math backend in its place; the math backend on the CPU."""
    assert vit.attention_backends(torch.device("cuda")) == [
        SDPBackend.EFFICIENT_ATTENTION]
    assert vit.attention_backends(torch.device("cpu")) == [SDPBackend.MATH]


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_attention_computes_in_f32_on_the_card():
    """The attention as the model calls it (``vit.attention_backends``), on
    the card at the cell's shapes of one client, against the f64 product:
    its error within 4x that of the f32 math backend with TF32 off, and at
    least 8x under that of TF32 operands, forward and the gradients of q,
    k, v; and its forward and backward are CUTLASS's memory-efficient
    kernels (``fmha_cutlassF``, ``fmha_cutlassB``), not the math backend's
    products."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator("cuda").manual_seed(3)
    q, k, v = (torch.randn((16, 12, 197, 64), device="cuda", generator=gen)
               for _ in range(3))
    up = torch.randn((16, 12, 197, 64), device="cuda", generator=gen)

    def errors(fn, cast):
        ins = [cast(t).detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*ins)
        (out * cast(up)).sum().backward()
        return [out.detach().double()] + [t.grad.double() for t in ins]

    def sdpa(backends):
        def fn(*ins):
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(*ins)
        return fn

    def tf32_math(*ins):
        r = [t + (t.view(torch.int32).add(0x1000).bitwise_and(~0x1FFF)
                  .view(torch.float32) - t).detach() for t in ins]
        a = torch.softmax(r[0] @ r[1].transpose(-1, -2) / 8, dim=-1)
        a = a + (a.view(torch.int32).add(0x1000).bitwise_and(~0x1FFF)
                 .view(torch.float32) - a).detach()
        return a @ r[2]

    exact = errors(sdpa([SDPBackend.MATH]), lambda t: t.double())
    model = errors(sdpa(vit.attention_backends(q.device)), lambda t: t)
    math_f32 = errors(sdpa([SDPBackend.MATH]), lambda t: t)
    tf32 = errors(tf32_math, lambda t: t)
    for want, got, plain, low in zip(exact, model, math_f32, tf32):
        scale = float(want.abs().max())
        e_got = float((got - want).abs().max()) / scale
        e_plain = float((plain - want).abs().max()) / scale
        e_low = float((low - want).abs().max()) / scale
        print(f"attention vs f64: model {e_got:.3g}, f32 math {e_plain:.3g},"
              f" tf32 {e_low:.3g}")
        assert e_got <= 4 * e_plain and 8 * e_got <= e_low

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        errors(sdpa(vit.attention_backends(q.device)), lambda t: t)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    assert any("fmha_cutlassF" in n for n in names), sorted(names)
    assert any("fmha_cutlassB" in n for n in names), sorted(names)
