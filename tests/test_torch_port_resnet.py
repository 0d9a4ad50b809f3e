"""Port ResNet-50 (GroupNorm) against the JAX package's and the plain
reference's, on the CPU.

The full ResNet-50 is held to the JAX package's parameter count and leaf
shapes (``jax.eval_shape``: no compute) and to the benchmark's
configuration file. The arithmetic is compared at a small size: four stages
of one block, width 32, 32 x 32 images, C = 2 clients of B = 2 images, with
distinct parameters a client and the same dropout masks on every side.

Tolerances (f32 on every side, each summing its convolutions and norms in
another order; measured here ~6e-6 of the largest logit and ~3e-6 of each
leaf's largest gradient between the port and the reference): logits within
5e-5 of the largest logit, each leaf's gradient within 5e-5 of its largest
element. Rounding every conv operand to TF32 (``reference/precision.py``,
the benchmark's control) moves them ~1e-3, so it fails both; the test
checks that too. The comparison's premise: no max-pool window holds two
live values, and no relu an input, closer than 1e-5 (a smaller gap could
route a gradient otherwise between two summation orders).
"""

from __future__ import annotations

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn
from torch.profiler import ProfilerActivity, profile

from multimodal_fl_security_tpu.core.pytrees import (
    flatten_stacked,
    flatten_tree,
)
from multimodal_fl_security_tpu.models import create_model as jax_create_model
from multimodal_fl_security_tpu.rounds.engine import (
    cross_entropy as jax_cross_entropy,
)
from multimodal_fl_security_tpu_torch.attacks import get_attack
from multimodal_fl_security_tpu_torch.data.stacking import ClientData
from multimodal_fl_security_tpu_torch.defenses import get_defense
from multimodal_fl_security_tpu_torch.models import create_model, resnet
from multimodal_fl_security_tpu_torch.models.from_jax import (
    _jax_shape,
    flat_from_jax,
    jax_paths,
    params_from_jax,
)
from multimodal_fl_security_tpu_torch.ops.client_dropout import RoundDraws
from multimodal_fl_security_tpu_torch.ops.fused_kernel import (
    kernel_step_takes,
)
from multimodal_fl_security_tpu_torch.rounds.engine import (
    RoundEngine,
    TrainSpec,
    cross_entropy,
    sgd_step,
)
from multimodal_fl_security_tpu_torch.utils import tracing
from torch_bench import federation
from torch_bench.cell import CHECKOUT, load_cell
from torch_bench.metrics import _program_spans
from torch_bench.reference import round as ref_round
from torch_bench.reference.models import resnet50 as ref_model
from torch_bench.trace import Trace

C, B, HW, K, WIDTH, STAGES = 2, 2, 32, 10, 32, (1, 1, 1, 1)
RATE = 0.3
#: f32 against f32 in another summation order (see the module docstring)
TOL = 5e-5
CELL = "resnet50_trimmed_alie_c20_f32"


def nchw(x):
    """NHWC numpy images (any leading axes) as an NCHW torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def small_model():
    return create_model("resnet50", num_classes=K, hidden_dim=32 * WIDTH,
                        image_size=(HW, HW), dropout_rates=(RATE,),
                        stage_sizes=STAGES, width=WIDTH)


def small_config(model):
    """The reference's configuration keys for ``model``."""
    return {"model": "resnet50", "in_channels": 3, "image_size": [HW, HW],
            "num_classes": K, "hidden_dim": 32 * WIDTH,
            "dropout_rates": [RATE], "stage_sizes": list(STAGES),
            "width": WIDTH, "groups": 32, "eps": 1e-6,
            "param_count": model.layout(3).dim,
            "leaves": [[n, list(s)] for n, s in model.layout(3).entries]}


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    jmodel = jax_create_model("resnet50", num_classes=K, stage_sizes=STAGES,
                              width=WIDTH, norm="group")
    images = rng.normal(size=(C, B, HW, HW, 3)).astype(np.float32)
    labels = rng.randint(0, K, size=(C, B)).astype(np.int32)
    mask = np.array([[1.0, 1.0], [1.0, 0.0]], np.float32)  # a ragged client
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), {"image": jnp.asarray(images[0])}))["params"]

    def draw(path, leaf):
        """Distinct parameters a client: kernels of variance 1 / fan_in,
        GroupNorm scales about 1, biases about 0."""
        noise = rng.normal(size=(C,) + leaf.shape).astype(np.float32)
        if len(leaf.shape) > 1:
            return noise / np.sqrt(np.prod(leaf.shape[:-1]))
        return (path[-1].key == "scale") + 0.1 * noise

    stacked = jax.tree_util.tree_map_with_path(draw, shapes)
    base = jax.tree_util.tree_map(lambda p: p[0], stacked)
    model = small_model()
    keep = torch.rand((C, B, 32 * WIDTH),
                      generator=torch.Generator().manual_seed(7)) < 1 - RATE
    return dict(jmodel=jmodel, model=model, images=images, labels=labels,
                mask=mask, base=base, stacked=stacked, keep=keep,
                params=params_from_jax(model, stacked, device="cpu"))


def jax_logits(case, p, x, keep):
    """One client's JAX logits in training mode, its dropout replaced by
    the given keep-mask."""
    def intercept(next_fun, args, kwargs, context):
        if isinstance(context.module, fnn.Dropout):
            return jnp.where(keep, args[0] / (1 - RATE), 0.0)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        return case["jmodel"].apply({"params": p}, {"image": x}, train=True)


def test_full_resnet50_matches_jax_and_the_configuration():
    jmodel = jax_create_model("resnet50", num_classes=200)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), {"image": jnp.zeros((1, 224, 224, 3))}))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    want = {tuple(k.key for k in path): tuple(v.shape) for path, v in leaves}
    model = create_model("resnet50", num_classes=200, hidden_dim=2048,
                         image_size=(224, 224), dropout_rates=(0.3,))
    layout = model.layout(3)
    assert len(want) == len(layout.entries) == 161
    assert sum(int(np.prod(s)) for s in want.values()) == layout.dim \
        == 23_917_832
    assert {path: _jax_shape(shape) for _, shape, path in
            jax_paths(model, 3)} == want
    config = load_cell(CELL).config
    assert [(n, tuple(s)) for n, s in config["leaves"]] == layout.entries
    assert config["param_count"] == layout.dim
    assert sum(1 for n, s in layout.entries if len(s) == 4) == 53
    assert set(config["control"]["layers"]) == {
        n[:-len(".weight")] for n, s in layout.entries if len(s) == 4} | {
        "fc"}


def test_factory_checks_its_widths():
    with pytest.raises(ValueError, match="pooled width"):
        create_model("resnet50", num_classes=200, hidden_dim=1024)
    with pytest.raises(ValueError, match="one dropout rate"):
        create_model("cub200_cnn", dropout_rates=(0.25, 0.5))
    with pytest.raises(ValueError, match="float32"):
        create_model("resnet50", dtype=torch.bfloat16)
    flat = small_model().init_params(3, torch.Generator().manual_seed(0))
    views = small_model().layout(3).views(flat)
    for name, v in views.items():
        if v.dim() > 1:  # lecun normal, truncated at 2 sigma
            fan_in = v[0].numel()
            assert v.abs().max() <= 2.0 / 0.8796 / fan_in ** 0.5 + 1e-6
        else:  # GroupNorm scale 1, every bias 0
            assert torch.equal(v, torch.full_like(
                v, 0.0 if name.endswith(".bias") else 1.0)), name


def test_flat_from_jax_is_an_exact_permutation(case):
    model, stacked = case["model"], case["stacked"]
    jflat = np.asarray(flatten_stacked(stacked))
    got = flat_from_jax(model, jflat, 3, device="cpu")
    assert torch.equal(got, case["params"])
    assert torch.equal(got.sort(dim=1).values,
                       torch.from_numpy(np.sort(jflat, axis=1)))
    single = flat_from_jax(model, np.asarray(flatten_tree(case["base"])), 3,
                           device="cpu")
    assert torch.equal(single, params_from_jax(model, case["base"],
                                               device="cpu"))


def stem_gaps(case):
    """The least gap between the two largest live values of a stem
    max-pool window, and the least |input| of a relu, over the clients."""
    model, layout = case["model"], case["model"].layout(3)
    x = nchw(case["images"])
    pool_gap, relu_gap = np.inf, np.inf
    for c in range(C):
        p = layout.views(case["params"][c])
        z = F.group_norm(F.conv2d(x[c], p["conv1.weight"], stride=2,
                                  padding=3), 32, p["bn1.weight"],
                         p["bn1.bias"], 1e-6)
        relu_gap = min(relu_gap, float(z.abs().min()))
        win = F.unfold(F.relu(z), 3, padding=1, stride=2)  # zero pads: < live
        top = win.view(B, z.shape[1], 9, -1).topk(2, dim=2).values
        live = top[:, :, 0] > 0
        pool_gap = min(pool_gap, float((top[:, :, 0] - top[:, :, 1])[live]
                                       .min()))
    return pool_gap, relu_gap


def port_loss(case, params):
    logits = case["model"](params, nchw(case["images"]),
                           RoundDraws(torch.Generator().manual_seed(7),
                                      (RATE,)))
    return logits, cross_entropy(logits, torch.from_numpy(case["labels"]),
                                 torch.from_numpy(case["mask"]))


def reference_loss(case, params, precision=None):
    config = small_config(case["model"])
    logits = ref_model.logits(params, nchw(case["images"]), (case["keep"],),
                              config, precision)
    return logits, ref_round.masked_ce(
        logits, torch.from_numpy(case["labels"]).long(),
        torch.from_numpy(case["mask"]), 0.0)


def test_logits_and_gradients_match_jax_and_the_reference(case):
    assert min(stem_gaps(case)) > 1e-5  # the comparison's premise
    model, layout = case["model"], case["model"].layout(3)
    keep = case["keep"].numpy()

    def client_loss(p, x, y, m, k):
        logits = jax_logits(case, p, x, k)
        return jax_cross_entropy(logits, y, m), logits

    jgrads, jlogits = jax.jit(jax.vmap(jax.grad(client_loss, has_aux=True)))(
        case["stacked"], jnp.asarray(case["images"]),
        jnp.asarray(case["labels"]), jnp.asarray(case["mask"]),
        jnp.asarray(keep))
    jax_grad = flat_from_jax(model, np.asarray(flatten_stacked(jgrads)), 3,
                             device="cpu")

    params = case["params"].clone().requires_grad_(True)
    logits, losses = port_loss(case, params)
    losses.sum().backward()
    rparams = case["params"].clone().requires_grad_(True)
    rlogits, rlosses = reference_loss(case, rparams)
    rlosses.sum().backward()
    tparams = case["params"].clone().requires_grad_(True)
    control = {n[:-len(".weight")]: "tf32" for n, s in layout.entries
               if len(s) == 4}
    tlogits, tlosses = reference_loss(case, tparams, control)
    tlosses.sum().backward()

    scale = float(rlogits.detach().abs().max())
    for want in (torch.tensor(np.asarray(jlogits)), rlogits.detach()):
        assert float((logits.detach() - want).abs().max()) <= TOL * scale
    assert float((tlogits.detach() - rlogits.detach()).abs().max()) \
        > TOL * scale  # TF32 operands fail the logits' tolerance
    got = layout.views(params.grad)
    tf32_worst = 0.0
    for want_flat in (jax_grad, rparams.grad):
        want = layout.views(want_flat)
        for name in got:
            top = float(want[name].abs().max())
            assert float((got[name] - want[name]).abs().max()) \
                <= TOL * top, name
    tf32 = layout.views(tparams.grad)
    ref = layout.views(rparams.grad)
    for name in got:
        tf32_worst = max(tf32_worst, float(
            (tf32[name] - ref[name]).abs().max() / ref[name].abs().max()))
    assert tf32_worst > TOL  # and the gradients' tolerance


def small_federation(seed=2**31 + 11):
    model = small_model()
    config = small_config(model)
    mix = {"clients": 5, "samples_per_client": 8, "batch_size": 4,
           "local_epochs": 1, "learning_rate": 0.001, "momentum": 0.9,
           "weight_decay": 1e-4, "clip_norm": 1.0, "label_smoothing": 0.0,
           "malicious_clients": 1,
           "attack": {"name": "alie", "config": {"num_malicious": 1}},
           "defense": {"name": "trimmed_mean",
                       "config": {"trim_ratio": 0.2}}}
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


def test_a_round_equals_the_plain_reference_round():
    engine, fed, config, mix = small_federation()
    new, metrics = engine.run_round(fed.theta0.clone(),
                                    federation.round_generator(fed, "cpu"))
    ref = ref_round.run_rounds(fed, config, mix,
                               federation.round_generator(fed, "cpu"), 1)
    # The same batches and masks: the loss agrees to f32 rounding (~3e-7
    # measured on three seeds; another draw order moves it 2-5%), and the
    # global change within 5% of its norm (0.4-0.6% measured: the change,
    # ~1e-5 of parameters near 1, keeps few f32 bits; another draw order
    # 78-86%).
    assert float(metrics["client_loss_mean"]) == pytest.approx(
        ref.losses[0], rel=1e-5)
    change = ref.thetas[1] - fed.theta0
    assert float((new - ref.thetas[1]).norm()) <= 0.05 * float(change.norm())


def test_the_kernel_trainer_does_not_take_resnet():
    spec = TrainSpec(batch_size=32)
    images = torch.zeros((2, 32, 1, 28, 28))
    assert not kernel_step_takes(small_model(), spec, images)


def test_a_weight_decay_step_equals_the_reference_sgd():
    gen = torch.Generator().manual_seed(3)
    rows = torch.randn((4, 1000), generator=gen)
    grad = torch.randn((4, 1000), generator=gen) * torch.tensor(
        [[0.01], [0.1], [1.0], [10.0]])  # under and over the clip
    traces = torch.randn((4, 1000), generator=gen)
    mix = {"clip_norm": 1.0, "weight_decay": 1e-4, "momentum": 0.9,
           "learning_rate": 0.001}
    spec = TrainSpec(**mix)
    want_rows, want_traces = rows.clone(), traces.clone()
    ref_round.sgd(want_rows, grad, want_traces, mix)
    got_rows, got_traces = rows.clone(), traces.clone()
    sgd_step(got_rows, grad, got_traces, spec)
    assert torch.equal(got_traces, want_traces)
    # the update: lr x trace rounded once (the reference) or fused
    ulp = torch.finfo(torch.float32).eps * rows.abs().max()
    assert float((got_rows - want_rows).abs().max()) <= float(ulp)
    assert not torch.equal(got_rows, rows)


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


def test_stage_spans_nest_under_forward_and_backward(traced):
    engine, fed, _, _ = traced
    traced_rounds(engine, fed, 2, profiled=True)
    spans = tracing.spans()
    by_id = {s.id: s for s in spans}
    steps = 2
    for r in sorted({s.round for s in spans}):
        mine = [s for s in spans if s.round == r]
        for kind, stages in (("forward", resnet.STAGES),
                             ("backward", [s + ".bwd" for s in
                                           resnet.STAGES])):
            parents = [s for s in mine if s.name == kind]
            assert len(parents) == steps
            for parent in parents:
                kids = [s for s in mine if s.parent == parent.id]
                names = [s.name for s in kids]
                if kind == "forward":
                    assert names == list(stages)
                else:  # the head's first
                    assert names == list(reversed(stages))
                for s in kids:
                    assert by_id[s.parent] is parent and s.round == r
                    assert parent.start_ns <= s.start_ns <= s.end_ns \
                        <= parent.end_ns
                ends = [s.end_ns for s in kids]
                assert ends == sorted(ends)
                assert all(a.end_ns <= b.start_ns
                           for a, b in zip(kids, kids[1:]))


def test_stage_edges_come_from_the_shared_backward_hooks(traced,
                                                        monkeypatch):
    """The backward's stage spans open and close at ``tracing.
    backward_spans``' hooks, shared with ViT: on each step's logits, each
    stage's output in backward order, then the stem's weight."""
    engine, fed, _, _ = traced
    calls = []
    shared = tracing.backward_spans

    def recorded(marks, device):
        calls.append([name for _, name in marks])
        return shared(marks, device)

    monkeypatch.setattr(tracing, "backward_spans", recorded)
    traced_rounds(engine, fed, 1, profiled=True)
    stages = [s + ".bwd" for s in reversed(resnet.STAGES)]
    assert calls == [stages + [None]] * 2  # two steps a round
    assert [s.name for s in tracing.spans() if s.name.endswith(".bwd")] == \
        stages * 2


def test_tracing_leaves_the_round_bitwise_unchanged(traced):
    engine, fed, _, _ = traced
    off = traced_rounds(engine, fed, 1, profiled=False)
    on = traced_rounds(engine, fed, 1, profiled=True)
    assert any(s.name == "stage1.bwd" for s in tracing.spans())
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
    # a step: the logits, the five stages' outputs and the stem's weight
    assert len(hooks) == 2 * 7


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
                 [x for st in resnet.STAGES for x in (st, st + ".bwd")]))
         for start in [base + 10 * k]]


@pytest.mark.parametrize("stage", resnet.STAGES)
def test_stage_readers_sum_forward_and_backward_a_round(stage, monkeypatch):
    reader = __import__(f"torch_bench.metrics.resnet_{stage}_device_ms",
                        fromlist=["read"])
    i = resnet.STAGES.index(stage)
    monkeypatch.setattr(_program_spans, "records", lambda: SPANS)
    # rounds 1 and 2 lie in the window; each holds the stage's forward
    # (1 + 2i ms) and backward (2 + 2i ms)
    got = reader.read(types.SimpleNamespace(trace=TRACE))
    assert got == pytest.approx(2 * ((1 + 2 * i) + (2 + 2 * i)) / 2)
    assert reader.read(types.SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(_program_spans, "records", lambda: [])
    assert reader.read(types.SimpleNamespace(trace=TRACE)) is None


def test_the_cell_is_in_the_benchmark():
    spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = load_cell(CELL)
    assert cell.chips == 1 and cell.config_name == "resnet50_gn_cub200_f32"
    assert [m["name"] for m in cell.per_layer] == [
        f"resnet_{s}_device_ms" for s in resnet.STAGES]
    assert ref_model.forward_flops_per_sample(cell.config) == 8_175_091_712
    mix = cell.traffic
    assert (mix["clients"], mix["samples_per_client"], mix["batch_size"]) \
        == (20, 48, 16)
    assert set(cell.limits) >= {"loss_gap_1", "rows_gap"}
    assert CELL in [w["name"] for w in spec["workloads"]]
