"""Port parity for the optimizers and optimizer-state layouts of
ops/optimizers.py: SGD (momentum, Nesterov, weight decay, the ``mom``
override), Lion, Adam and Lamb with bf16 and int8 moments laid out per
parameter group, compensated Adam (bf16 and fp16 parameters), and the
chunked update against the whole-tensor one.

Each runs 5 steps against the JAX optimizer on the same params and
grads (numpy, from a seed). The JAX tree stacks the block parameters
over layers (``h/ln_1/scale`` [L, ...]) as the JAX GPT-2 does; the port
holds one tensor per layer (``h.<i>.ln_1.scale``), so an int8 first
moment spans the group's layers in both.

Tolerances: parameters atol = rtol = 1e-6 in float32 (the same
elementwise float32 arithmetic; XLA may fuse a multiply-add where
PyTorch rounds twice, and LAMB's norms sum in another order); int8
codes and scales, compensated parameters, SGD and Lion bit for bit
(observed equal); compensated codes equal but for at most 1 in 1000,
within 2 code steps (see that test); bf16 moments within one bf16 ulp (2**-8
relative: a float32 moment one ulp apart can round to the neighbouring
bf16 value). The chunked update equals the whole-tensor update bit for
bit (the same operations on views).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.ops import quant as tq
from torch_test_env import jax_compile_cache  # noqa: F401

TOL = dict(atol=1e-6, rtol=1e-6)
BF16_TOL = dict(atol=1e-12, rtol=2.0 ** -8)
L = 3
# stacked over L layers in the JAX tree; "h/ln_1/scale" is 3 x 770 =
# 2310 elements, so its int8 blocks straddle the layers
SHAPES = {"h/ln_1/scale": (L, 770), "h/inter_w": (L, 48, 96),
          "wte": (256, 64), "b": (7,)}
STEPS = 5
CHUNK = 4096  # a lowered chunk threshold that engages the chunked path
LR, GSCALE = 1e-2, 0.7


def _jtree(arrs, cast=jnp.asarray):
    return {"h": {"ln_1": {"scale": cast(arrs["h/ln_1/scale"])},
                  "inter_w": cast(arrs["h/inter_w"])},
            "wte": cast(arrs["wte"]), "b": cast(arrs["b"])}


def _jflat(tree):
    """The JAX tree back to the flat numpy layout of SHAPES."""
    f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))
    return {"h/ln_1/scale": f(tree["h"]["ln_1"]["scale"]),
            "h/inter_w": f(tree["h"]["inter_w"]), "wte": f(tree["wte"]),
            "b": f(tree["b"])}


def _tdict(arrs):
    """The flat layout as the port's per-layer state dict, the block
    matrix transposed to the port's [out, in] as convert.py does."""
    out = {}
    for key, a in arrs.items():
        a = np.asarray(a)
        if key.startswith("h/"):
            for i in range(L):
                leaf = a[i].T if key == "h/inter_w" else a[i]
                out[f"h.{i}.{key[2:].replace('/', '.')}"] = torch.from_numpy(
                    np.array(leaf))
        else:
            out[key] = torch.from_numpy(np.array(a))
    return out


def _data(seed=0):
    rng = np.random.default_rng(seed)
    params = {k: (rng.normal(size=s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * 0.01).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    return params, grads


def _run(jo, to, p_dtype=None, mom=None):
    """5 steps of both; returns (jax params, jax state, jax aux, port
    params, port state, port aux)."""
    p0, grads = _data()
    jp, tp = _jtree(p0), _tdict(p0)
    if p_dtype is not None:
        jp = jax.tree_util.tree_map(lambda x: x.astype(getattr(jnp, p_dtype)),
                                    jp)
        tp = {k: v.to(getattr(torch, p_dtype)) for k, v in tp.items()}
    js, ts = jo.init(jp), to.init(tp)
    kw = {} if mom is None else {"mom": mom}
    for g in grads:
        jp, js, jaux = jo.apply(jp, _jtree(g), js, jnp.float32(LR),
                                grad_scale=jnp.float32(GSCALE),
                                **({} if mom is None
                                   else {"mom": jnp.float32(mom)}))
        taux = to.apply(tp, _tdict(g), ts, LR, grad_scale=GSCALE, **kw)
    return jp, js, jaux, tp, ts, taux


def _assert_params(jp, tp, exact=False):
    want = _tdict(_jflat(jp))
    for k, t in tp.items():
        if exact:
            assert torch.equal(t.float(), want[k]), k
        else:
            np.testing.assert_allclose(t.float().numpy(), want[k].numpy(),
                                       err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# SGD and Lion
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(), dict(momentum=0.9), dict(momentum=0.9, nesterov=True),
    dict(momentum=0.9, weight_decay=0.01),
    dict(momentum=0.5, nesterov=True, weight_decay=0.1),
    dict(weight_decay=0.01),
], ids=["plain", "momentum", "nesterov", "momentum_wd", "nesterov_wd", "wd"])
def test_sgd_matches_jax(kw):
    jp, js, _, tp, ts, _ = _run(jopt.SGD(**kw), topt.SGD(**kw))
    _assert_params(jp, tp, exact=True)
    assert ts["step"] == int(js["step"]) == STEPS
    if kw.get("momentum"):
        want = _tdict(_jflat(js["mom"]))
        for k, m in ts["mom"].items():
            assert torch.equal(m, want[k]), k
    else:
        assert ts["mom"] is None and js["mom"] is None


def test_sgd_supports_mom_only_with_momentum():
    assert topt.SGD(momentum=0.9).supports_mom
    assert not topt.SGD().supports_mom
    assert topt.SGD(momentum=0.9).supports_mom == jopt.SGD(
        momentum=0.9).supports_mom


def test_sgd_mom_override_matches_static_momentum():
    """test_momentum_cycling's SGD case: ``apply(mom=0.85)`` equals an SGD
    built with momentum 0.85, and matches the JAX override."""
    jp, _, _, tp, ts, _ = _run(jopt.SGD(momentum=0.9),
                               topt.SGD(momentum=0.9), mom=0.85)
    _assert_params(jp, tp, exact=True)
    _, _, _, tp_static, ts_static, _ = _run(jopt.SGD(momentum=0.85),
                                            topt.SGD(momentum=0.85))
    for k in tp:
        assert torch.equal(tp[k], tp_static[k]), k
        assert torch.equal(ts["mom"][k], ts_static["mom"][k]), k


@pytest.mark.parametrize("opt_cls", [topt.Adam, topt.Lamb])
def test_mom_override_matches_static_b1(opt_cls):
    """test_momentum_cycling's Adam/Lamb case, in the port: the override
    equals a static b1 bit for bit (the bias correction is host float32
    arithmetic on the same numbers)."""
    p0, grads = _data()
    runs = []
    for opt, mom in ((opt_cls(b1=0.9), 0.85), (opt_cls(b1=0.85), None)):
        tp = _tdict(p0)
        ts = opt.init(tp)
        for g in grads:
            opt.apply(tp, _tdict(g), ts, LR, grad_scale=GSCALE, mom=mom)
        runs.append((tp, ts))
    (pd, sd), (ps, ss) = runs
    for k in pd:
        assert torch.equal(pd[k], ps[k]), k
        assert torch.equal(sd["mu"][k], ss["mu"][k]), k


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_lion_matches_jax(wd):
    jp, js, _, tp, ts, _ = _run(jopt.Lion(weight_decay=wd),
                                topt.Lion(weight_decay=wd))
    _assert_params(jp, tp, exact=True)
    want = _tdict(_jflat(js["mu"]))
    for k, m in ts["mu"].items():
        assert torch.equal(m, want[k]), k
    assert not topt.Lion().supports_mom


# ---------------------------------------------------------------------------
# reduced-precision moments, per group
# ---------------------------------------------------------------------------
def _check_moments(js, ts, state_dtype):
    """bf16: each stored moment within a bf16 ulp of JAX's; int8: every
    group's codes and scales equal JAX's stacked leaf's, bit for bit."""
    groups = {"h.*.ln_1.scale": js["mu"]["h"]["ln_1"]["scale"],
              "h.*.inter_w": js["mu"]["h"]["inter_w"],
              "wte": js["mu"]["wte"], "b": js["mu"]["b"]}
    if state_dtype == "int8":
        assert set(ts["mu"]) == set(groups)
        for g, jleaf in groups.items():
            np.testing.assert_array_equal(ts["mu"][g]["q"].numpy(),
                                          np.asarray(jleaf["q"]), err_msg=g)
            np.testing.assert_array_equal(ts["mu"][g]["scale"].numpy(),
                                          np.asarray(jleaf["scale"]),
                                          err_msg=g)
        moments = ("nu",)
    else:
        moments = ("mu", "nu")
    for role in moments:
        want = _tdict(_jflat(js[role]))
        for k, m in ts[role].items():
            assert m.dtype == torch.bfloat16
            np.testing.assert_allclose(m.float().numpy(), want[k].numpy(),
                                       err_msg=f"{role} {k}", **BF16_TOL)


@pytest.mark.parametrize("state_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_reduced_state_matches_jax(state_dtype, adam_w_mode):
    kw = dict(state_dtype=state_dtype, weight_decay=0.01,
              adam_w_mode=adam_w_mode)
    jp, js, _, tp, ts, _ = _run(jopt.Adam(**kw), topt.Adam(**kw))
    _assert_params(jp, tp)
    _check_moments(js, ts, state_dtype)


@pytest.mark.parametrize("state_dtype", ["bf16", "int8"])
def test_lamb_reduced_state_matches_jax(state_dtype):
    """Lamb's trust ratios, one per group, equal the JAX per-leaf ratios
    (the JAX leaves are the port's groups, in the same order)."""
    kw = dict(state_dtype=state_dtype, weight_decay=0.01)
    jp, js, jaux, tp, ts, taux = _run(jopt.Lamb(**kw), topt.Lamb(**kw))
    _assert_params(jp, tp)
    _check_moments(js, ts, state_dtype)
    got = np.array([float(c) for c in taux["lamb_coeffs"]])
    want = np.array([float(c) for c in jaux["lamb_coeffs"]])
    # JAX's leaf order: b, h/inter_w, h/ln_1/scale, wte
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)


def test_int8_first_moment_is_one_leaf_per_group():
    """A group's layers share one flat quantized leaf (blocks straddle
    layer boundaries), the second moment stays per tensor in bf16; a
    linear weight lies in it in JAX's [in, out] element order."""
    p0, _ = _data()
    state = topt.Adam(state_dtype="int8").init(_tdict(p0))
    leaf = state["mu"]["h.*.ln_1.scale"]
    assert tq.is_quantized(leaf)
    assert leaf["q"].numel() == 2 * tq.BLOCK  # 2310 elements -> 2 blocks
    assert state["nu"]["h.1.ln_1.scale"].dtype == torch.bfloat16
    w = torch.arange(6.0).reshape(2, 3)  # [out, in]
    assert torch.equal(topt.jax_element_order("h.0.inter_w", w), w.t())
    assert torch.equal(topt.jax_element_order("pooler.weight", w), w.t())
    assert topt.jax_element_order("wte", w) is w
    bias = w[0]
    assert topt.jax_element_order("h.0.inter_b", bias) is bias


def test_fused_lamb_refuses_reduced_state():
    from deepspeed_tpu_torch.ops.fused_lamb import FusedLamb

    with pytest.raises(ValueError, match="fp32 moments"):
        FusedLamb(state_dtype="bf16")


# ---------------------------------------------------------------------------
# compensated masters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p_dtype", ["bfloat16", "float16"])
def test_compensated_adam_matches_jax(p_dtype):
    """Parameters in the compute dtype equal JAX's bit for bit after 5
    steps; their int8 codes equal JAX's but for at most 1 in 1000, each
    within 2 code steps (a code step is ulp/127 of the parameter, and the
    float32 master it encodes may differ by an ulp where XLA fuses a
    multiply-add: 2 and 1 of 32 525 codes differ by 1 and 2, observed)."""
    kw = dict(master_compensation=True, weight_decay=0.01)
    jp, js, _, tp, ts, _ = _run(jopt.Adam(**kw), topt.Adam(**kw),
                                p_dtype=p_dtype)
    for k, t in tp.items():
        assert t.dtype == getattr(torch, p_dtype)
    _assert_params(jp, tp, exact=True)
    want = _tdict(_jcomp_flat(js["comp"]))
    differ = total = 0
    for k, c in ts["comp"].items():
        assert c.dtype == torch.int8
        d = (c.int() - want[k].int()).abs()
        assert int(d.max()) <= 2, k
        differ += int((d > 0).sum())
        total += c.numel()
    assert differ <= total // 1000, (differ, total)
    assert sum(int((c != 0).sum()) for c in ts["comp"].values()) > total // 2


def _jcomp_flat(comp):
    return {"h/ln_1/scale": np.asarray(comp["h"]["ln_1"]["scale"]),
            "h/inter_w": np.asarray(comp["h"]["inter_w"]),
            "wte": np.asarray(comp["wte"]), "b": np.asarray(comp["b"])}


def test_compensated_adam_tracks_the_fp32_master():
    """The JAX package's property (test_memory_savers.py:246): bf16
    params with int8 codes follow the fp32-master trajectory within 1% of
    its loss, and plain bf16 params (no codes) land ten times farther."""
    rng = np.random.default_rng(0)
    target = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))

    def loss_and_grad(w):
        w = w.detach().requires_grad_()
        loss = ((w.float() - target) ** 2).mean()
        return loss, torch.autograd.grad(loss, w)[0]

    def run(opt, dtype):
        p = {"w": torch.zeros(256, 64, dtype=dtype)}
        state = opt.init(p)
        for _ in range(300):
            # the forward sees bf16 weights in all three runs
            _, g = loss_and_grad(p["w"].to(torch.bfloat16))
            opt.apply(p, {"w": g}, state, 1e-3)
        return float(loss_and_grad(p["w"].to(torch.bfloat16))[0].detach())

    lm = run(topt.Adam(), torch.float32)
    lc = run(topt.Adam(master_compensation=True), torch.bfloat16)
    lp = run(topt.Adam(), torch.bfloat16)
    assert abs(lc - lm) / lm < 0.01, (lm, lc)
    assert abs(lp - lm) > 10 * abs(lc - lm), (lm, lc, lp)


# ---------------------------------------------------------------------------
# the chunked update
# ---------------------------------------------------------------------------
def test_slice_count_matches_jax():
    for L_, size, thr in ((50304, 50304 * 768, None), (48, 48 * 1600 * 6400,
                                                       None),
                          (7, 7000, 1000), (97, 97 * 100, 1000),
                          (10, 10_000, 100), (4, 4000, 4000)):
        assert topt._slice_count(L_, size, thr) == jopt._slice_count(
            L_, size, thr), (L_, size, thr)


def test_gpt2_wte_updates_in_two_row_groups():
    """GPT-2's wte [50304, 768] (38.6M elements) takes the chunked update
    in two halves, where the JAX one would."""
    wte = torch.empty(50304, 768, device="meta")
    assert topt.chunk_rows(wte) == [(0, 25152), (25152, 50304)]
    assert topt.chunk_rows(wte, quantized=True) is not None
    assert topt.chunk_rows(torch.empty(1024, 768, device="meta")) is None


@pytest.mark.parametrize("layout", ["fp32", "bf16", "int8", "compensated",
                                    "int8_flat"])
def test_chunked_update_equals_whole_tensor_update(layout):
    """The same 5 steps with the chunk threshold lowered so that the 2-d
    tensors here update in row groups, against the default threshold
    (whole tensors): parameters and state equal bit for bit."""
    p0, grads = _data(1)
    kw = {}
    p_dtype = torch.float32
    if layout in ("bf16", "int8", "int8_flat"):
        kw["state_dtype"] = layout[:4]
    if layout == "compensated":
        kw["master_compensation"] = True
        p_dtype = torch.bfloat16
    runs = []
    for threshold in (1 << 25, CHUNK):
        opt = topt.Adam(weight_decay=0.01, chunk_elements=threshold,
                        flat_quant_update=layout == "int8_flat", **kw)
        tp = {k: v.to(p_dtype) for k, v in _tdict(p0).items()}
        ts = opt.init(tp)
        for g in grads:
            opt.apply(tp, _tdict(g), ts, LR, grad_scale=GSCALE)
        runs.append((tp, ts))
    # wte [256, 64] takes 4 row groups of 4096 elements (whole int8
    # blocks), each layer's inter_w [96, 48] two
    assert topt.chunk_rows(torch.empty(256, 64), CHUNK,
                           quantized=True) == [(0, 64), (64, 128),
                                               (128, 192), (192, 256)]
    assert len(topt.chunk_rows(torch.empty(96, 48), CHUNK)) == 2
    (pw, sw), (pc, sc) = runs
    for k in pw:
        assert torch.equal(pw[k], pc[k]), k

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return []

    for a, b in zip(leaves(sw), leaves(sc)):
        assert torch.equal(a, b)


def test_jax_chunked_update_matches_the_port_int8():
    """Both packages' chunked paths (threshold lowered) give the same int8
    codes for the lone large tensor (wte), and scales within 2 float32
    ulps: XLA compiles the JAX chunk loop into another fused program,
    whose first moment may differ by an ulp (observed: 1 scale of 8)."""
    kw = dict(state_dtype="int8", chunk_elements=CHUNK)
    _, js, _, _, ts, _ = _run(jopt.Adam(**kw), topt.Adam(**kw))
    np.testing.assert_array_equal(ts["mu"]["wte"]["q"].numpy(),
                                  np.asarray(js["mu"]["wte"]["q"]))
    np.testing.assert_allclose(ts["mu"]["wte"]["scale"].numpy(),
                               np.asarray(js["mu"]["wte"]["scale"]),
                               rtol=2.0 ** -22, atol=0.0)


def test_build_optimizer_builds_every_jax_optimizer():
    for name, cls in (("sgd", topt.SGD), ("lion", topt.Lion),
                      ("adam", topt.Adam), ("lamb", topt.Lamb)):
        opt = topt.build_optimizer(name, {"lr": 0.1})
        jo = jopt.build_optimizer(name, {"lr": 0.1})
        assert isinstance(opt, cls)
        assert ({f.name for f in dataclasses.fields(jo)}
                >= {f.name for f in dataclasses.fields(opt)})
    sgd = topt.build_optimizer("SGD", {"lr": 0.1, "momentum": 0.9,
                                       "nesterov": True})
    assert sgd.momentum == 0.9 and sgd.nesterov
    lion = topt.build_optimizer("Lion", {"lr": 0.1, "betas": (0.8, 0.95)})
    assert (lion.b1, lion.b2) == (0.8, 0.95)
