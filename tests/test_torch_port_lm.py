"""The LM extras of the port against the JAX package, on the CPU.

The scan's whole surface (``ops/scan.py``: the gate z, the last state,
reverse, the three B/C layouts, complex A, the pooling helpers), K1's
plain chunk-parallel version with z and the last state, the decode ops
(``causal_conv1d_update``, ``selective_state_update``), the vision
mixer's cached step, and ``models/lm.py``: logits, prefill caches, the
decode step, greedy ``generate``, ``prepare_logits``, sampling and eos
pinning. Inputs come from numpy seeds; the LM's weights are the JAX
model's (the JAX tests' ``tiny_lm``: vocab 64, d_model 32, 2 layers,
d_state 4), carried across by ``utils.convert.lm_from_jax_params``.

Tolerances: the scans and steps are fp32 on both sides in other orders
(the log-depth scans combine steps in another order than the sequential
oracle), |got - want| <= 1e-5 + 1e-5·|want|; logits after 2 layers
2e-5. The port's side runs under ``torch.set_num_threads(1)`` (ROADMAP
§3: torch's CPU exp on a worker thread beside XLA's runtime).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.models import lm as jlm
from fastvim_tpu.models.mixer import MambaMixer as JaxMixer
from fastvim_tpu.ops import conv as jconv
from fastvim_tpu.ops import scan as jscan
from fastvim_tpu.ops.state_update import (
    selective_state_update as jax_state_update,
)
from fastvim_tpu_torch.models import lm
from fastvim_tpu_torch.models.mixer import MambaMixer
from fastvim_tpu_torch.ops import (
    broadcast_tokens,
    causal_conv1d_update,
    pool_tokens,
    selective_scan,
    selective_state_update,
)
from fastvim_tpu_torch.ops.kernels import selective_scan as ss
from fastvim_tpu_torch.utils.convert import (
    cache_from_jax,
    lm_from_jax_params,
    to_jax_params,
)

TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=2e-5, atol=2e-5)
# the JAX side jitted: its eager applies dispatch op by op and cost most
# of the file's time
_STATIC = ("delta_softplus", "reverse", "return_last_state")
jax_scan = jax.jit(jscan.selective_scan, static_argnames=_STATIC + ("impl",))
jax_scan_ref = jax.jit(jscan.selective_scan_ref, static_argnames=_STATIC)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _scan_inputs(seed, batch=2, L=37, d=16, n=4, layout="bln",
                 complex_a=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    bc = {"bln": (batch, L, n), "dn": (d, n), "grouped": (batch, L, 2, n),
          "interleaved": (batch, 2 * L, n)}[layout]
    a = dict(u=f(batch, L, d), delta=0.5 * f(batch, L, d),
             A=-np.exp(rng.uniform(-1, 1, (d, n))).astype(np.float32),
             B=f(*bc), C=f(*bc), D=rng.uniform(-1, 1, d).astype(np.float32),
             z=f(batch, L, d),
             delta_bias=rng.uniform(-0.5, 0.5, d).astype(np.float32))
    if complex_a:
        a["A"] = (a["A"] + 1j * rng.uniform(-2, 2, (d, n))).astype(
            np.complex64)
        if layout != "interleaved":
            a["B"] = (a["B"] + 1j * f(*bc)).astype(np.complex64)
            a["C"] = (a["C"] + 1j * f(*bc)).astype(np.complex64)
    return a


def _check_scan(a, reverse, last_dtype):
    """The port's selective_scan with impl "auto" and "ref" against JAX's
    oracle (impl="ref"), y and the last state."""
    kw = dict(D=a["D"], z=a["z"], delta_bias=a["delta_bias"],
              delta_softplus=True, reverse=reverse, return_last_state=True)
    arrays = [k for k, v in kw.items() if isinstance(v, np.ndarray)]
    wy, wlast = jax_scan(
        *(jnp.asarray(a[k]) for k in ("u", "delta", "A", "B", "C")),
        impl="ref", **{**kw, **{k: jnp.asarray(kw[k]) for k in arrays}})
    for impl in ("auto", "ref"):
        y, last = selective_scan(
            *(_t(a[k]) for k in ("u", "delta", "A", "B", "C")), impl=impl,
            **{**kw, **{k: _t(kw[k]) for k in arrays}})
        assert last.dtype == last_dtype and last.shape == wlast.shape
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL,
                                   err_msg=impl)
        np.testing.assert_allclose(last.numpy(), np.asarray(wlast), **TOL,
                                   err_msg=impl)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layout", ["bln", "dn", "grouped"])
def test_scan_gate_last_state_layouts(layout, reverse):
    """y gated by silu(z) after D·u and the last state in scan order,
    against JAX's sequential ``selective_scan_ref``: (batch, L, n) B/C
    through the CPU path of K1's route (the sequential reference), (d, n)
    and grouped B/C through the log-depth scan, and all of them through
    the oracle with ``impl="ref"``."""
    _check_scan(_scan_inputs(7 + reverse, layout=layout), reverse,
                torch.float32)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("layout", ["bln", "dn", "interleaved"])
def test_complex_scan_matches_jax(layout, reverse):
    """Complex A in real pairs (the log-depth scan, and the oracle with
    ``impl="ref"``), with complex B/C in two layouts and the torch
    convention's time-interleaved real pairs: y and the complex64 last
    state."""
    _check_scan(_scan_inputs(11 + reverse, L=21, layout=layout,
                             complex_a=True), reverse, torch.complex64)


def test_complex_scan_refuses_pallas():
    a = _scan_inputs(3, layout="bln", complex_a=True)
    with pytest.raises(ValueError, match="complex"):
        selective_scan(*(_t(a[k]) for k in ("u", "delta", "A", "B", "C")),
                       impl="pallas")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [1, 64, 65, 200])
def test_chunked_plain_gate_and_last_state(L, reverse):
    """K1's chunk-parallel plain version with z and the last state (the
    state pass carried past the last chunk) against JAX's sequential
    reference in fp32: one step, one whole chunk, one step past it, a
    partial fourth chunk (scanned first when reversed)."""
    a = _scan_inputs(100 + L + reverse, L=L, d=16, n=8)
    y, states, last = ss.selective_scan_fwd_chunked_plain(
        *(_t(a[k]) for k in ("u", "delta", "A", "B", "C", "D",
                             "delta_bias")), True, reverse, z=_t(a["z"]),
        return_last_state=True)
    assert states.shape == (2, -(-L // 64), 16, 8)
    wy, wlast = jax_scan_ref(
        *(jnp.asarray(a[k]) for k in ("u", "delta", "A", "B", "C")),
        D=jnp.asarray(a["D"]), z=jnp.asarray(a["z"]),
        delta_bias=jnp.asarray(a["delta_bias"]), delta_softplus=True,
        return_last_state=True, reverse=reverse)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(last.numpy(), np.asarray(wlast), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_function_gate_gradients(reverse):
    """``SelectiveScanFn`` with z (the K1/K2 route, plain versions on the
    CPU) against ``jax.grad`` of the JAX reference: all eight inputs'
    gradients of Σ y·w, the last state returned and not differentiated."""
    a = _scan_inputs(21 + reverse, L=40)
    w = np.random.default_rng(5).standard_normal(a["u"].shape).astype(
        np.float32)
    names = ("u", "delta", "A", "B", "C", "D", "delta_bias", "z")
    t = {k: _t(a[k]).requires_grad_() for k in names}
    y, last = selective_scan(t["u"], t["delta"], t["A"], t["B"], t["C"],
                             D=t["D"], delta_bias=t["delta_bias"], z=t["z"],
                             delta_softplus=True, reverse=reverse,
                             return_last_state=True)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    assert not last.requires_grad
    (y * _t(w)).sum().backward()

    def loss(*args):
        kw = dict(zip(names, args))
        return jnp.sum(jscan.selective_scan_ref(
            kw["u"], kw["delta"], kw["A"], kw["B"], kw["C"], D=kw["D"],
            z=kw["z"], delta_bias=kw["delta_bias"], delta_softplus=True,
            reverse=reverse) * w)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(8))))(
        *(jnp.asarray(a[k]) for k in names))
    for k, g in zip(names, want):
        scale = max(1.0, float(np.abs(np.asarray(g)).max()))
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=k)


def test_decode_ops_match_jax():
    """``causal_conv1d_update`` (window oldest first, with and without a
    bias and the SiLU) and ``selective_state_update`` (with and without
    D, z and dt_bias) against the JAX ops."""
    rng = np.random.default_rng(2)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, state, w, b = f(3, 8), f(3, 4, 8), f(4, 8), f(8)
    for bias, act in ((b, "silu"), (None, None)):
        y, new = causal_conv1d_update(_t(x), _t(state), _t(w), _t(bias), act)
        wy, wnew = jconv.causal_conv1d_update(
            jnp.asarray(x), jnp.asarray(state), jnp.asarray(w),
            None if bias is None else jnp.asarray(bias), act)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_array_equal(new.numpy(), np.asarray(wnew))
    ssm, A = f(3, 8, 4), -np.exp(f(8, 4))
    args = (ssm, x, 0.5 * f(3, 8), A, f(3, 4), f(3, 4))
    for extra in (dict(D=f(8), z=f(3, 8), dt_bias=f(8), dt_softplus=True),
                  {}):
        targs = tuple(map(_t, args))
        y, new = selective_state_update(
            *targs, **{k: _t(v) if isinstance(v, np.ndarray) else v
                       for k, v in extra.items()})
        np.testing.assert_array_equal(targs[0].numpy(), ssm)  # kept
        wy, wnew = jax_state_update(
            *map(jnp.asarray, args),
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in extra.items()})
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(new.numpy(), np.asarray(wnew), **TOL)


@pytest.mark.parametrize("method,scale", [("mean", 1.0), ("mean", 0.5),
                                          ("max", 1.0)])
def test_pool_and_broadcast_tokens_match_jax(method, scale):
    x = np.random.default_rng(4).standard_normal((2, 12, 5)).astype(
        np.float32)
    got = pool_tokens(_t(x), 3, 4, method, scale)
    want = jscan.pool_tokens(jnp.asarray(x), 3, 4, method, scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        broadcast_tokens(got, 4).numpy(),
        np.asarray(jscan.broadcast_tokens(jnp.asarray(got.numpy()), 4)))


@pytest.mark.parametrize("use_norm", [True, False])
def test_mixer_cached_step_matches_jax(use_norm):
    """The vision mixer's decode step, three tokens from a zero cache:
    outputs and both cache entries (conv window, fp32 state) against the
    JAX mixer's, with and without the post-SSM LayerNorm."""
    mixer = MambaMixer(32, d_state=4, use_norm_after_ssm=use_norm,
                       layer_fused="off")
    mixer.reset_parameters(torch.Generator().manual_seed(9))
    sd = {f"layers.0.mixer.{k}": v.detach().numpy()
          for k, v in mixer.state_dict().items()}
    params = jax.tree_util.tree_map(
        jnp.asarray,
        {"params": to_jax_params(sd)["params"]["layers_0"]["mixer"]})
    jmixer = JaxMixer(d_model=32, d_state=4, use_norm_after_ssm=use_norm)
    jstep = jax.jit(lambda p, x, c: jmixer.apply(p, x, cache=c))
    xs = np.random.default_rng(6).standard_normal((3, 2, 1, 32)).astype(
        np.float32)
    cache = mixer.init_cache(2)
    jcache = jmixer.init_cache(2)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {
        k: tuple(v.shape) for k, v in jcache.items()}
    assert cache["ssm"].dtype == torch.float32
    for x in xs:
        with torch.no_grad():
            out, cache = mixer(_t(x), cache=cache)
        jout, jcache = jstep(params, jnp.asarray(x), jcache)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), **TOL)
    # and from the JAX cache carried across, the same step
    with torch.no_grad():
        out, _ = mixer(_t(xs[0]), cache=cache_from_jax(jcache))
    jout, _ = jstep(params, jnp.asarray(xs[0]), jcache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


# --- the language model ------------------------------------------------------

class _Jax:
    """The JAX model's forward, prefill and decode step, jitted."""

    def __init__(self, model):
        self.model = model
        self.fwd = jax.jit(model.apply)
        self.prefill = jax.jit(lambda p, t: model.apply(p, t, prefill=True))
        self.step = jax.jit(lambda p, t, c: model.apply(p, t, caches=c))


@pytest.fixture(scope="module")
def tiny():
    """(the JAX model's jitted functions, its params, the port's model
    with the same weights)."""
    jmodel = jlm.MambaLMHeadModel(vocab_size=64, d_model=32, n_layer=2,
                                  d_state=4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4), jnp.int32))
    model = lm.MambaLMHeadModel(vocab_size=64, d_model=32, n_layer=2,
                                d_state=4)
    sd = lm_from_jax_params(jax.tree_util.tree_map(np.asarray, params))
    model.load_state_dict({k: torch.from_numpy(v.copy())
                           for k, v in sd.items()})
    return _Jax(jmodel), params, model.eval()


def _tokens(seed, batch, L, vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, (batch, L),
                                                dtype=np.int32)


def test_lm_names_and_converter(tiny):
    """The reference's parameter names, the padded vocabulary, and the
    converter's refusal of a leaf it does not know."""
    jmodel, params, model = tiny
    names = set(model.state_dict())
    assert "backbone.embedding.weight" in names
    assert "backbone.layers.1.mixer.dt_proj.bias" in names
    assert "backbone.layers.0.norm.weight" in names
    assert "backbone.norm_f.weight" in names
    assert model.padded_vocab == jmodel.model.padded_vocab == 64
    assert lm.MambaLMHeadModel(vocab_size=50277, n_layer=1).padded_vocab \
        == 50280
    bad = jax.tree_util.tree_map(np.asarray, params)
    bad["params"]["layers_0"]["extra"] = np.zeros(3)
    with pytest.raises(ValueError, match="layers_0/extra"):
        lm_from_jax_params(bad)


def test_lm_logits_prefill_and_decode_match_jax(tiny):
    """Full-sequence logits; the prefill's logits and per-layer caches;
    then three decode steps from those caches, logits and caches."""
    jmodel, params, model = tiny
    toks = _tokens(1, 2, 6)
    with torch.no_grad():
        logits = model(_t(toks))
        pre, caches = model(_t(toks), prefill=True)
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jmodel.fwd(params, toks)),
                               **LOGIT_TOL)
    jpre, jcaches = jmodel.prefill(params, toks)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **LOGIT_TOL)
    for steps in range(3):
        for (cw, ss_), (jw, js) in zip(caches, jcaches):
            assert cw.dtype == ss_.dtype == torch.float32
            np.testing.assert_allclose(cw.numpy(), np.asarray(jw), **TOL)
            np.testing.assert_allclose(ss_.numpy(), np.asarray(js), **TOL)
        nxt = _tokens(10 + steps, 2, 1)
        with torch.no_grad():
            step, caches = model(_t(nxt), caches=caches)
        jstep, jcaches = jmodel.step(params, nxt, jcaches)
        np.testing.assert_allclose(step.numpy(), np.asarray(jstep),
                                   **LOGIT_TOL)


def test_lm_short_prompt_cache_and_zero_cache(tiny):
    """A prompt shorter than the conv window pads the window in front;
    a zero cache (``init_cache``) decodes as JAX's does."""
    jmodel, params, model = tiny
    toks = _tokens(3, 2, 2)
    with torch.no_grad():
        _, caches = model(_t(toks), prefill=True)
        step, _ = model(_t(toks[:, :1]), caches=model.init_cache(2))
    _, jcaches = jmodel.prefill(params, toks)
    for (cw, _), (jw, _) in zip(caches, jcaches):
        np.testing.assert_allclose(cw.numpy(), np.asarray(jw), **TOL)
    zero = [jlm.MambaLM(d_model=32, d_state=4, n_layer=2).init_cache(2)
            for _ in range(2)]
    jstep, _ = jmodel.step(params, toks[:, :1], zero)
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **LOGIT_TOL)


def test_greedy_generate_matches_jax(tiny):
    """Greedy generation, token for token against JAX's, and ``top_k=1``
    greedy whatever the temperature."""
    jmodel, params, model = tiny
    prompt = _tokens(4, 2, 5)
    got = lm.generate(model, _t(prompt), 8, temperature=0.0)
    want = jlm.generate(jmodel.model, params, jnp.asarray(prompt), 8,
                        temperature=0.0)
    assert got.shape == (2, 13) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        lm.generate(model, _t(prompt), 8, temperature=5.0, top_k=1).numpy(),
        got.numpy())


def test_eos_pins_the_tail(tiny):
    """Greedy with eos the first generated token of row 0: row 0's tail is
    all eos, and both rows equal JAX's (the port stops once every row has
    its eos and fills the rest)."""
    jmodel, params, model = tiny
    prompt = _tokens(5, 2, 4)
    eos = int(lm.generate(model, _t(prompt), 1, temperature=0.0)[0, -1])
    got = lm.generate(model, _t(prompt), 6, temperature=0.0,
                      eos_token_id=eos).numpy()
    want = np.asarray(jlm.generate(jmodel.model, params,
                                   jnp.asarray(prompt), 6,
                                   temperature=0.0, eos_token_id=eos))
    assert (got[0, 4:] == eos).all()
    np.testing.assert_array_equal(got, want)
    both = lm.generate(model, _t(prompt[:1].repeat(2, 0)), 6,
                       temperature=0.0, eos_token_id=eos).numpy()
    assert both.shape == (2, 10) and (both[:, 4:] == eos).all()


def test_prepare_logits_matches_jax():
    """Penalty, top-k, temperature and top-p against JAX's
    ``prepare_logits`` on tie-free logits over the config grid: the -inf
    positions equal, the rest within fp32 rounding."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 97)) * 3).astype(np.float32)
    seen = np.zeros((3, 97), bool)
    for b, ts in enumerate(([1, 5, 90], [0], list(range(20)))):
        seen[b, ts] = True
    for temp in (1.0, 0.7):
        for top_k in (None, 10, 1):
            for top_p in (0.0, 0.9, 0.5):
                for pen in (1.0, 1.3):
                    cfg = (temp, top_k, top_p, pen)
                    got = lm.prepare_logits(_t(logits), *cfg,
                                            _t(seen)).numpy()
                    want = np.asarray(jlm.prepare_logits(
                        jnp.asarray(logits), *cfg, jnp.asarray(seen)))
                    finite = np.isfinite(want)
                    np.testing.assert_array_equal(np.isfinite(got), finite,
                                                  err_msg=str(cfg))
                    np.testing.assert_allclose(got[finite], want[finite],
                                               rtol=1e-6, atol=1e-6,
                                               err_msg=str(cfg))


def test_sampling_is_seeded_and_stays_in_the_kept_set(tiny):
    """One ``torch.Generator`` seed gives the same tokens twice; every
    sampled token survives ``prepare_logits`` at its step (penalty over
    prompt and generated tokens, top-k, temperature, top-p), read from
    the teacher-forced logits."""
    _, _, model = tiny
    prompt = _t(_tokens(8, 2, 4))
    cfg = dict(temperature=0.8, top_k=6, top_p=0.8, repetition_penalty=1.3)
    run = lambda seed: lm.generate(
        model, prompt, 10, generator=torch.Generator().manual_seed(seed),
        **cfg)
    out = run(3)
    assert torch.equal(out, run(3))
    with torch.no_grad():
        logits = model(out[:, :-1])
    for t in range(10):
        pos = 4 + t
        seen = torch.zeros(2, 64, dtype=torch.bool)
        seen[torch.arange(2)[:, None], out[:, :pos].long()] = True
        kept = torch.isfinite(lm.prepare_logits(
            logits[:, pos - 1], cfg["temperature"], cfg["top_k"],
            cfg["top_p"], cfg["repetition_penalty"], seen))
        assert kept.sum(-1).le(6).all()
        assert kept[torch.arange(2), out[:, pos].long()].all(), t


def test_create_lm_device_rule():
    """``create_lm`` builds on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.create_lm(n_layer=1, d_model=32, vocab_size=64)
    model = lm.create_lm("cpu", n_layer=1, d_model=32, vocab_size=64)
    assert next(model.parameters()).device.type == "cpu"
