"""The port's roofline accounting (``repro_torch.launch.analytic_cost``,
``roofline``, ``mesh``) against the reference's (``repro.launch``).

The FLOP counter: the counterparts of ``tests/test_roofline.py``'s jaxpr
cases on ``meta`` tensors (a matmul, a loop, nested loops, a gradient,
checkpointed recompute), convolutions against the reference's
``_conv_flops``, and the attention charge: the reference's count of its
own ``_chunked_attention`` (and of ``jax.grad`` of it), whatever runs
inside ``FlashAttentionFn``.  The whole-step count of one arch of each
family (train, prefill, decode; ``reduce_config``, B=2, S=64) equals the
reference's ``count_flops`` of its own step within 1e-6 relative, after
the ops where the two programs compute different products are taken out
of each side by their closed forms (:func:`named_ops`).  The other
counts (``model_flops_estimate``, ``hbm_bytes_per_chip`` and
``collective_bytes_from_hlo``) equal the reference's exactly.  Inputs are
shapes; where values enter (the CPU run of a step), numpy draws from a
seed.
"""
import dataclasses
import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.configs import base as jbase
from repro.launch import analytic_cost as jac
from repro.launch import roofline as jrl
from repro.models import attention as jattention
from repro.models import zoo as jzoo
from repro.serve.serve_step import make_decode_step as jdecode_step
from repro.serve.serve_step import make_prefill_step as jprefill_step
from repro.train.optimizer import init_opt_state as jinit_opt
from repro.train.train_step import AdamWConfig as JAdamW
from repro.train.train_step import make_train_step as jtrain_step
from repro_torch.configs.base import (ARCH_IDS, SHAPES, ShapeSpec,
                                      get_config, get_shape, reduce_config)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn
from repro_torch.launch import analytic_cost as ac
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import roofline as rl
from repro_torch.models import zoo
from repro_torch.serve.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_step import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "_torch_families", ROOT / "tests" / "_torch_families.py")
FAM = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(FAM)

#: relative bound of the whole-step counts, after the named ops
REL = 1e-6
B, S = 2, 64


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


# ------------------------------------------------------------- the counter
class TestDispatchFlops:
    @pytest.mark.parametrize("form", ["matmul", "out", "in_place"])
    def test_matmul(self, form):
        n = 64
        c = meta(n, n)
        f = {"matmul": lambda x, y: x @ y,
             "out": lambda x, y: torch.mm(x, y, out=c),
             "in_place": lambda x, y: c.addmm_(x, y)}[form]
        assert ac.count_flops(f, meta(n, n), meta(n, n)) == 2 * n ** 3

    def test_loop_multiplies_by_length(self):
        # the reference's scan over L steps is a Python loop here
        n, L = 32, 10

        def f(w):
            h = torch.eye(n, device=w.device)
            for _ in range(L):
                h = h @ w
            return h

        assert ac.count_flops(f, meta(n, n)) == L * 2 * n ** 3

    def test_nested_loops(self):
        n, L1, L2 = 16, 3, 5

        def f(w):
            h = torch.eye(n, device=w.device)
            for _ in range(L1):
                for _ in range(L2):
                    h = h @ w
            return h

        assert ac.count_flops(f, meta(n, n)) == L1 * L2 * 2 * n ** 3

    def test_grad_includes_backward(self):
        n = 32

        def loss(w, x):
            return torch.sum((x @ w) ** 2)

        def grad(w, x):
            return torch.autograd.grad(loss(w, x), (w,))

        fwd = ac.count_flops(loss, meta(n, n), meta(n, n))
        both = ac.count_flops(grad, meta(n, n, grad=True), meta(n, n))
        assert both >= 1.9 * fwd  # fwd matmul + x^T @ g in bwd

    def test_checkpoint_recompute_counted(self):
        n = 32

        def body(x, w):
            return torch.tanh(x @ w) @ w

        def plain(w, x):
            return torch.autograd.grad(torch.sum(body(x, w)), (w,))

        def remat(w, x):
            y = checkpoint(body, x, w, use_reentrant=False)
            return torch.autograd.grad(torch.sum(y), (w,))

        got = ac.count_flops(remat, meta(n, n, grad=True), meta(n, n))
        want = ac.count_flops(plain, meta(n, n, grad=True), meta(n, n))
        # the first product is recomputed; the checkpoint stops before the
        # second, whose output the backward does not need (early stop)
        assert got == want + 2 * n ** 3

    @pytest.mark.parametrize("n,cin,cout,k,groups", [
        (2, 3, 8, 3, 1), (1, 8, 8, 5, 8), (3, 4, 6, 1, 2)])
    def test_convolution_matches_reference(self, n, cin, cout, k, groups):
        h = w = 12
        ref = jac.count_flops(
            lambda x, f: jax.lax.conv_general_dilated(
                x, f, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                         "NHWC"),
                feature_group_count=groups),
            jax.ShapeDtypeStruct((n, h, w, cin), jnp.float32),
            jax.ShapeDtypeStruct((k, k, cin // groups, cout), jnp.float32))
        got = ac.count_flops(
            lambda x, f: torch.nn.functional.conv2d(
                x, f, padding="same", groups=groups),
            meta(n, cin, h, w), meta(cout, cin // groups, k, k))
        assert got == ref

    def test_peak_of_live_tensors(self):
        mb = 1 << 20

        def f(x):
            a = x + 1          # 1 MiB live
            b = a * 2          # 2 MiB
            del a              # 1 MiB
            c = b.view(-1)     # a view: nothing new
            d = c.exp()        # 2 MiB
            return d, b

        x = meta(mb // 4)  # an argument: made before the walk
        with ac.StepCount() as count:
            out = f(x)
        assert count.peak_bytes == 2 * mb
        assert count.live_bytes == 2 * mb
        del out


# ------------------------------------------------------ the attention charge
def _jax_chunked(causal, qc, kc, impl="chunked"):
    def f(q, k, v):
        pos = jnp.arange(q.shape[1])
        return jattention.grouped_attention(
            q, k, v, causal=causal, q_pos=pos, kv_pos=jnp.arange(k.shape[1]),
            impl=impl, q_chunk=qc, kv_chunk=kc)
    return f


@pytest.mark.parametrize("causal,s,skv,qc,kc,impl", [
    (True, 64, 64, 16, 8, "chunked"), (True, 64, 64, 32, 32, "chunked"),
    (True, 64, 64, 8, 16, "chunked"), (True, 64, 64, 16, 8,
                                       "chunked_noskip"),
    (False, 64, 64, 16, 16, "chunked"), (False, 48, 16, 16, 8, "chunked"),
    (True, 60, 60, 16, 16, "chunked")])  # 60 % 16: the naive path
def test_attention_charge_is_the_reference_count(causal, s, skv, qc, kc,
                                                 impl):
    """The forward charge equals the reference's count of its own
    attention at the call's tiling, and forward + backward equals its
    count of ``jax.grad`` of it."""
    b, kv, g, dqk, dv = 2, 2, 3, 24, 16
    shapes = ((b, s, kv, g, dqk), (b, skv, kv, dqk), (b, skv, kv, dv))
    jargs = [jax.ShapeDtypeStruct(x, jnp.float32) for x in shapes]
    f = _jax_chunked(causal, qc, kc, impl)
    ref_fwd = jac.count_flops(f, *jargs)
    ref_grad = jac.count_flops(jax.grad(lambda *a: jnp.sum(f(*a)),
                                        argnums=(0, 1, 2)), *jargs)
    tiling = (qc, kc, impl)
    got = ac.attention_flops((b, kv * g, s, dqk), (b, kv, skv, dqk),
                             (b, kv, skv, dv), causal=causal, tiling=tiling)
    assert got == ref_fwd
    assert ref_grad == 3 * ref_fwd  # the backward is charged 2x

    def step(q, k, v):
        o = flash_ops.flash_attention_op(q, k, v, causal=causal)
        return torch.autograd.grad(o.sum(), (q, k, v))

    t = [meta(b, kv * g, s, dqk, grad=True), meta(b, kv, skv, dqk, grad=True),
         meta(b, kv, skv, dv, grad=True)]
    assert ac.count_flops(step, *t, tiling=tiling) == ref_grad
    # the count's class stands in only while the count is open
    assert flash_ops.FlashAttentionFn is FlashAttentionFn


def _reduced(arch):
    return reduce_config(get_config(arch))


def _cpu_model_inputs(cfg, rng):
    model = zoo.init_model(cfg, 0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in FAM.batch(cfg, B, S, rng).items()}
    return model, batch


@pytest.mark.parametrize("arch", ["smollm-135m", "seamless-m4t-medium"])
def test_charge_does_not_depend_on_what_runs_inside(arch):
    """A train step counts the same on ``meta`` (empty outputs inside
    ``FlashAttentionFn``), on the CPU (the plain versions inside) and with
    the plain attention swapped for another implementation (SDPA)."""
    cfg = _reduced(arch)
    step = make_train_step(cfg)
    model, batch = _cpu_model_inputs(cfg, np.random.default_rng(0))
    tiling = ac.tiling_of(cfg)
    on_cpu = ac.count_flops(step, model, init_opt_state(
        dict(model.named_parameters())), batch, tiling=tiling)

    def sdpa(q, k, v, *, causal=True):
        g = q.shape[1] // k.shape[1]
        return torch.nn.functional.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            is_causal=causal)

    with mock.patch.object(flash_ops, "attention_ref", sdpa), \
            mock.patch.object(flash_ops, "attention_bwd_ref",
                              lambda q, k, v, o, do, lse, causal: (
                                  torch.zeros_like(q), torch.zeros_like(k),
                                  torch.zeros_like(v))):
        swapped = ac.count_flops(step, model, init_opt_state(
            dict(model.named_parameters())), batch, tiling=tiling)
    mmodel = zoo.init_model(cfg, device="meta")
    on_meta = ac.count_flops(step, mmodel, init_opt_state(
        dict(mmodel.named_parameters())),
        zoo.input_specs(cfg, ShapeSpec("t", "train", S, B)), tiling=tiling)
    assert on_cpu == swapped == on_meta > 0


# ------------------------------------------------- whole steps, per family
def _ssd_products(cfg, q, chunks, *, port: bool):
    """Products of the Mamba-2 SSD chunk loop's forward, one layer, as
    each side counts them (batch B, chunks of ``q`` positions): the
    scores C·Bᵀ, the intra-chunk y, the carried state's y (``y_inter``)
    and the state update (``contrib``).  The reference's einsums of
    three operands contract the decay in as a product of its own, 2·B·Q·H
    ·min(P, N) each; the port's torch.einsum multiplies it in, and at Q = 1
    (a decode step) contracts the size-1 positions by multiplying (no
    product)."""
    s = cfg.ssm
    H = s.expand * cfg.d_model // s.headdim
    P, N = s.headdim, s.d_state
    scores = 2.0 * B * q * q * N
    intra = 2.0 * B * H * q * q * P
    inter = contrib = 2.0 * B * q * H * P * N
    if port:
        if q == 1:
            intra = contrib = 0.0
        return chunks * (scores + intra + inter + contrib), contrib
    decay = 2.0 * B * q * H * min(P, N)
    return chunks * (scores + intra + inter + contrib + 2 * decay), contrib


def named_ops(cfg, kind: str, *, port: bool) -> tuple[float, list]:
    """The FLOPs that each side counts for the ops where the two programs
    compute different products, and their names:

    - ``loss chunk`` (train): the vocab product of each loss chunk, 2·B·S
      ·d·V over the chunks; the port runs each chunk under ``checkpoint``
      and recomputes it in the backward (4 passes), the reference's scan
      keeps it (3);
    - ``moe combine`` (train, a MoE layer with shared experts): the
      routed rows' weighted sum, 2·T·k·d; the reference's remat drops its
      recompute as dead (3 passes), the port's checkpoint replays it on
      the way to the shared experts after it (4);
    - ``ssd`` (the hybrid's Mamba-2 layers): :func:`_ssd_products`; in
      train the port's autograd takes no backward of the last chunk's
      state update, which no gradient reaches, and its checkpoint stops
      its recompute before it (early stop), where the reference's scan
      body runs for every chunk: 4 passes less 3 of the last ``contrib``
      against 4 passes."""
    total, names = 0.0, []
    if kind == "train":
        n_text = S - (min(cfg.frontend_tokens, S // 4)
                      if cfg.frontend == "patch" else 0)
        total += (4 if port else 3) * 2.0 * B * n_text * cfg.d_model * \
            cfg.vocab
        names.append("loss chunk")
        if cfg.moe is not None and cfg.moe.n_shared:
            n_moe = cfg.n_layers - cfg.moe.first_dense_layers
            passes = 4 if port else 3
            total += passes * n_moe * 2.0 * B * S * cfg.moe.top_k * \
                cfg.d_model
            names.append("moe combine")
    if cfg.family == "hybrid":
        q = 1 if kind == "decode" else min(cfg.ssm.chunk, S)
        chunks = 1 if kind == "decode" else S // q
        fwd, contrib = _ssd_products(cfg, q, chunks, port=port)
        per_layer = fwd
        if kind == "train":
            per_layer = 4 * fwd - (3 * contrib if port else 0.0)
        total += cfg.n_layers * per_layer
        names.append("ssd")
    return total, names


def _reference_counts(arch: str) -> dict:
    cfg = jbase.reduce_config(jbase.get_config(arch))
    tcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = jax.eval_shape(lambda: jzoo.init_model(tcfg, jax.random.key(0)))
    out = {"train": jac.count_flops(
        jtrain_step(tcfg, JAdamW(), microbatches=1), params,
        jax.eval_shape(jinit_opt, params),
        jzoo.input_specs(tcfg, jbase.ShapeSpec("t", "train", S, B)))}
    params = jax.eval_shape(lambda: jzoo.init_model(cfg, jax.random.key(0)))
    out["prefill"] = jac.count_flops(
        jprefill_step(cfg, S), params,
        jzoo.input_specs(cfg, jbase.ShapeSpec("p", "prefill", S, B)))
    out["decode"] = jac.count_flops(
        jdecode_step(cfg), params, jzoo.init_cache_specs(cfg, B, S),
        jzoo.input_specs(cfg, jbase.ShapeSpec("d", "decode", S, B)),
        jax.ShapeDtypeStruct((), jnp.int32))
    return out


def _port_counts(arch: str) -> dict:
    cfg = _reduced(arch)
    tcfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    tiling = ac.tiling_of(cfg)
    model = zoo.init_model(tcfg, device="meta")
    out = {"train": ac.count_flops(
        make_train_step(tcfg), model,
        init_opt_state(dict(model.named_parameters())),
        zoo.input_specs(tcfg, ShapeSpec("t", "train", S, B)),
        tiling=tiling)}
    model = zoo.init_model(cfg, device="meta")
    out["prefill"] = ac.count_flops(
        make_prefill_step(cfg, S, device="meta"), model,
        zoo.input_specs(cfg, ShapeSpec("p", "prefill", S, B)), tiling=tiling)
    out["decode"] = ac.count_flops(
        make_decode_step(cfg, device="meta"), model,
        zoo.init_cache(cfg, B, S, device="meta"),
        zoo.input_specs(cfg, ShapeSpec("d", "decode", S, B)), S // 2,
        tiling=tiling)
    return out


@pytest.mark.parametrize("family", sorted(FAM.FAMILIES))
def test_whole_step_count_matches_reference(family):
    arch = FAM.FAMILIES[family]
    cfg = _reduced(arch)
    ref, got = _reference_counts(arch), _port_counts(arch)
    for kind in ("train", "prefill", "decode"):
        ref_named, names = named_ops(cfg, kind, port=False)
        got_named, _ = named_ops(cfg, kind, port=True)
        want = ref[kind] - ref_named
        assert want > 0
        assert abs((got[kind] - got_named) - want) <= REL * want, (
            kind, names, got[kind], ref[kind])


def test_microbatches_are_the_same_work():
    """The dry run walks one microbatch and multiplies (``dryrun._train``):
    a step of m microbatches counts m times the step on B / m rows."""
    cfg = dataclasses.replace(_reduced("smollm-135m"), param_dtype="bfloat16")
    model = zoo.init_model(cfg, device="meta")

    def count(micro: int, rows: int) -> float:
        return ac.count_flops(
            make_train_step(cfg, microbatches=micro), model,
            init_opt_state(dict(model.named_parameters())),
            zoo.input_specs(cfg, ShapeSpec("t", "train", S, rows)),
            tiling=ac.tiling_of(cfg))

    assert count(4, 8) == 4 * count(1, 2)


# --------------------------------------------------------- the other counts
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_reference(arch):
    jcfg, cfg = jbase.get_config(arch), get_config(arch)
    for name in SHAPES:
        assert rl.model_flops_estimate(cfg, get_shape(name)) == \
            jrl.model_flops_estimate(jcfg, jbase.get_shape(name))


class FakeMesh:
    shape = {"data": 16, "model": 16}


@pytest.mark.parametrize("mesh", [FakeMesh(),
                                  port_mesh.make_production_mesh()],
                         ids=["16x16", "1xh100"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hbm_bytes_per_chip_matches_reference(arch, mesh):
    jcfg, cfg = jbase.get_config(arch), get_config(arch)
    for name in SHAPES:
        for mode in ("train", "prefill", "decode"):
            kw = dict(mode=mode, microbatches=4, cache_bytes_total=4.3e12)
            assert ac.hbm_bytes_per_chip(cfg, get_shape(name), mesh,
                                         **kw) == \
                jac.hbm_bytes_per_chip(jcfg, jbase.get_shape(name), mesh,
                                       **kw)


def _reference_hlo_cases():
    spec = importlib.util.spec_from_file_location(
        "_reference_roofline_tests", ROOT / "tests" / "test_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [mod.SYNTH_HLO, "ENTRY %m (x: f32[4]) -> f32[4] {\n}"]


@pytest.mark.parametrize("hlo", _reference_hlo_cases(),
                         ids=["synth", "empty"])
def test_collective_bytes_from_hlo_matches_reference(hlo):
    assert rl.collective_bytes_from_hlo(hlo) == \
        jrl.collective_bytes_from_hlo(hlo)


def test_one_card_has_no_collectives():
    zero = rl.collective_bytes_from_ops([])
    assert zero == rl.collective_bytes_from_hlo(
        "ENTRY %m (x: f32[4]) -> f32[4] {\n}")
    assert zero["total_bytes"] == 0.0


def test_derive_terms_reads_the_cards_peaks():
    t = rl.derive_terms(arch="a", shape="s", mesh_name="1xh100", chips=1,
                        flops_global=989e12, hbm_bytes_chip=3.35e12,
                        coll={"total_bytes": 450e9}, model_flops=494.5e12,
                        bytes_per_device=1.0)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 1.0, 1.0)
    assert t.useful_ratio == 0.5
    assert port_mesh.HBM_PER_CHIP == 80e9
    assert port_mesh.PEAK_FLOPS_FP32 == 67e12


@pytest.mark.parametrize("make,sizes", [
    (lambda: port_mesh.make_production_mesh(multi_pod=True), (2, 16, 16)),
    (lambda: port_mesh.make_production_mesh(multi_pod=True, pods=4),
     (4, 16, 16)),
    (lambda: port_mesh.Mesh(("data", "model"), (2, 1)), (2, 1)),
    (lambda: port_mesh.Mesh(("data", "model"), (16, 16)), (16, 16))],
    ids=["multi_pod", "4_pods", "2x1", "16x16"])
def test_larger_meshes_are_described(make, sizes):
    """A larger mesh is described, not built: for the spec functions, and
    for a dry run, which walks it as rank 0 of a fake world
    (``launch/mesh.py::fake_world``); a mesh over pods is the reference's
    ``(pods, 16, 16)`` over ``("pod", "data", "model")``.  It builds no
    device mesh."""
    m = make()
    names = ("pod", "data", "model")[-len(sizes):]
    assert m.shape == dict(zip(names, sizes)) and m.axis_names == names
    assert m.size == int(np.prod(sizes)) and m.device_mesh is None
    if len(sizes) == 2 and sizes[0] > 2:
        assert m == port_mesh.make_production_mesh(pod=True)
    m = port_mesh.make_production_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m.axis_names == ("data", "model")
