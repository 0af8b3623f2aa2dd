"""The port's HF snapshot loader and lm_eval scoring against the JAX
package, on the CPU.

A local snapshot directory (``config.json`` and ``pytorch_model.bin``
under the reference's names, seeded as ``tests/test_hf.py`` seeds it) is
loaded by both packages' ``lm_from_pretrained``; their logits agree
within 2e-5 (fp32, 3 layers, sums in other orders). The scoring
primitives (``loglikelihood``, ``loglikelihood_rolling``,
``rolling_windows``) and the ``lm_eval`` adapter (against a stub of
``lm_eval.api``, copied from ``tests/test_lm_harness_api.py``) agree with
the JAX package's within 1e-4 relative on log-likelihoods summed over a
few tokens, and exactly on greedy flags, windows and generated text.
"""

import abc
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvim_tpu.evals import lm_harness as jharness
from fastvim_tpu.models.lm import MambaLMHeadModel as JaxLM
from fastvim_tpu.utils import hf as jhf
from fastvim_tpu_torch.evals import lm_harness
from fastvim_tpu_torch.models.lm import MambaLMHeadModel
from fastvim_tpu_torch.utils import hf
from fastvim_tpu_torch.utils.convert import lm_from_jax_params

CFG = dict(d_model=64, n_layer=3, vocab_size=100, rms_norm=True,
           residual_in_fp32=True, fused_add_norm=True,
           pad_vocab_size_multiple=8, ssm_cfg=dict(d_state=8))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make_state_dict(seed=31):
    """A reference-named MambaLMHeadModel state dict (as
    ``tests/test_hf.py`` makes it): d_model 64, 3 layers, d_state 8, the
    vocab 100 padded to 104, the LM head tied."""
    torch.manual_seed(seed)
    d, d_inner, d_state, d_conv = 64, 128, 8, 4
    dt_rank = -(-d // 16)
    sd = {"backbone.embedding.weight": torch.randn(104, d) * 0.02,
          "backbone.norm_f.weight": torch.ones(d) + 0.1 * torch.randn(d)}
    for i in range(CFG["n_layer"]):
        p = f"backbone.layers.{i}"
        sd[f"{p}.norm.weight"] = torch.ones(d) + 0.1 * torch.randn(d)
        m = f"{p}.mixer"
        sd[f"{m}.in_proj.weight"] = torch.randn(2 * d_inner, d) * 0.05
        sd[f"{m}.conv1d.weight"] = torch.randn(d_inner, 1, d_conv) * 0.2
        sd[f"{m}.conv1d.bias"] = torch.randn(d_inner) * 0.1
        sd[f"{m}.x_proj.weight"] = (
            torch.randn(dt_rank + 2 * d_state, d_inner) * 0.05)
        sd[f"{m}.dt_proj.weight"] = torch.randn(d_inner, dt_rank) * 0.1
        sd[f"{m}.dt_proj.bias"] = torch.randn(d_inner) * 0.5 - 2.0
        sd[f"{m}.A_log"] = torch.log(torch.arange(
            1, d_state + 1, dtype=torch.float32).repeat(d_inner, 1))
        sd[f"{m}.D"] = torch.ones(d_inner)
        sd[f"{m}.out_proj.weight"] = torch.randn(d, d_inner) * 0.05
    sd["lm_head.weight"] = sd["backbone.embedding.weight"]
    return sd


def _snapshot(path, sd, cfg=CFG, name="pytorch_model.bin"):
    path.mkdir(exist_ok=True)
    (path / "config.json").write_text(json.dumps(cfg))
    if name == "pytorch_model.bin":
        torch.save(sd, path / name)
    else:
        from safetensors.torch import save_file

        save_file({k: v.clone() for k, v in sd.items()}, str(path / name))
    return str(path)


def test_lm_from_pretrained_matches_jax(tmp_path):
    """Both packages load one snapshot; logits agree, on a tokens batch
    of two rows. The safetensors file loads to the same weights."""
    sd = _make_state_dict()
    path = _snapshot(tmp_path / "bin", sd)
    model = hf.lm_from_pretrained(path, device="cpu")
    assert model.padded_vocab == 104 and model.d_state == 8
    toks = np.random.default_rng(0).integers(0, 100, (2, 11), np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    jmodel, params = jhf.lm_from_pretrained(path)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(toks)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    st = hf.lm_from_pretrained(
        _snapshot(tmp_path / "st", sd, name="model.safetensors"),
        device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, st.state_dict()[k]), k


def test_lm_from_pretrained_refuses(tmp_path):
    """A missing directory, a directory without weights, a vocabulary
    whose padding does not match the embedding, and (without a card) the
    default device."""
    with pytest.raises(FileNotFoundError, match="config.json"):
        hf.lm_from_pretrained(str(tmp_path / "absent"), device="cpu")
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "config.json").write_text(json.dumps(CFG))
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        hf.lm_from_pretrained(str(tmp_path / "empty"), device="cpu")
    bad = _snapshot(tmp_path / "bad", _make_state_dict(),
                    {**CFG, "pad_vocab_size_multiple": 16})
    with pytest.raises(ValueError, match="padded vocab 112"):
        hf.lm_from_pretrained(bad, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hf.lm_from_pretrained(bad)


@pytest.fixture(scope="module")
def small():
    """The JAX harness tests' model (vocab 32, d_model 16, 2 layers,
    d_state 4): (JAX model, params, the port's model)."""
    jmodel = JaxLM(vocab_size=32, d_model=16, n_layer=2, d_state=4)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 8), jnp.int32))
    model = MambaLMHeadModel(vocab_size=32, d_model=16, n_layer=2, d_state=4)
    model.load_state_dict({
        k: torch.from_numpy(v.copy()) for k, v in lm_from_jax_params(
            jax.tree_util.tree_map(np.asarray, params)).items()})
    return jmodel, params, model.eval()


def _close_scores(got, want):
    assert len(got) == len(want)
    for (a, ga), (b, gb) in zip(got, want):
        assert isinstance(a, float) and isinstance(ga, bool)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        assert ga == gb


def test_scoring_matches_jax(small):
    """``loglikelihood`` over ragged pairs in two batches (an empty
    context scored from one token), ``rolling_windows`` and
    ``loglikelihood_rolling`` with and without a window limit."""
    jmodel, params, model = small
    pairs = [([3, 5, 7], [2, 9]), ([1], [4, 6, 8]), ([2, 2, 2, 2, 2], [0]),
             ([], [5, 5])]
    _close_scores(lm_harness.loglikelihood(model, pairs, batch_size=3),
                  jharness.loglikelihood(jmodel, params, pairs,
                                         batch_size=3))
    doc = [3, 5, 7, 2, 9, 4, 1, 6, 8]
    for n in (0, 1, 4, 9):
        for max_len in (1, 4, 7):
            assert lm_harness.rolling_windows(doc[:n], max_len, 0) == \
                jharness.rolling_windows(doc[:n], max_len, 0)
    for max_len in (None, 4):
        got = lm_harness.loglikelihood_rolling(
            model, [doc, doc[:3]], max_seq_len=max_len, prefix_token=1)
        want = jharness.loglikelihood_rolling(
            jmodel, params, [doc, doc[:3]], max_seq_len=max_len,
            prefix_token=1)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    tokens, lens = lm_harness._pad_batch([np.arange(3), np.arange(70)])
    assert tokens.shape == (2, 128) and list(lens) == [3, 70]


# --- the lm_eval adapter, against a stub of lm_eval.api ----------------------

class _FakeLM(abc.ABC):
    """Mirrors lm_eval.api.model.LM's abstract surface."""

    def __init__(self):
        pass

    @abc.abstractmethod
    def loglikelihood(self, requests):
        ...

    @abc.abstractmethod
    def loglikelihood_rolling(self, requests):
        ...

    @abc.abstractmethod
    def generate_until(self, requests):
        ...


_REGISTRY = {}


def _register_model(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


class _Request:
    """lm_eval.api.instance.Instance look-alike: .args tuple."""

    def __init__(self, *args):
        self.args = args


class _CharTokenizer:
    """One token per character."""

    eos_token_id = 0

    def encode(self, s):
        return [ord(c) % 30 + 1 for c in s]

    def decode(self, ids):
        return "".join(chr((i - 1) % 30 + 97) for i in ids)


@pytest.fixture
def fake_lm_eval(monkeypatch):
    pkg = types.ModuleType("lm_eval")
    api = types.ModuleType("lm_eval.api")
    model_mod = types.ModuleType("lm_eval.api.model")
    reg_mod = types.ModuleType("lm_eval.api.registry")
    model_mod.LM = _FakeLM
    reg_mod.register_model = _register_model
    api.model = model_mod
    api.registry = reg_mod
    pkg.api = api
    for name, mod in [("lm_eval", pkg), ("lm_eval.api", api),
                      ("lm_eval.api.model", model_mod),
                      ("lm_eval.api.registry", reg_mod)]:
        monkeypatch.setitem(sys.modules, name, mod)
    _REGISTRY.clear()
    return pkg


def test_eval_wrapper_matches_jax(fake_lm_eval, small):
    """The registered wrapper's three methods against the JAX package's
    wrapper on the same requests: scores, rolling scores over a document
    longer than ``max_length``, and greedy text cut at its stop strings."""
    jmodel, params, model = small
    tok = _CharTokenizer()
    lm = lm_harness.make_eval_wrapper(model, tok, max_length=8,
                                      batch_size=2)
    assert _REGISTRY["fastvim_mamba"] is lm
    lm = lm()
    jlm_ = jharness.make_eval_wrapper(jmodel, params, tok, max_length=8,
                                      batch_size=2)()
    reqs = [_Request("hello", " world"), _Request("abc", "def"),
            _Request("", "x")]
    _close_scores(lm.loglikelihood(reqs), jlm_.loglikelihood(reqs))
    rolls = [_Request("a much longer rolling document")]
    np.testing.assert_allclose(lm.loglikelihood_rolling(rolls),
                               jlm_.loglikelihood_rolling(rolls), rtol=1e-4)
    gens = [_Request("ab", {"max_gen_toks": 6}),
            _Request("cd", {"until": ["q", "e"], "max_gen_toks": 5})]
    got = lm.generate_until(gens)
    assert got == jlm_.generate_until(gens)
    assert len(got[0]) == 6 and "q" not in got[1] and "e" not in got[1]


def test_eval_wrapper_needs_lm_eval(monkeypatch):
    for name in list(sys.modules):
        if name.startswith("lm_eval"):
            monkeypatch.delitem(sys.modules, name)
    real = __import__

    def blocking(name, *a, **kw):
        if name.startswith("lm_eval"):
            raise ImportError(name)
        return real(name, *a, **kw)

    monkeypatch.setattr("builtins.__import__", blocking)
    with pytest.raises(ImportError, match="lm_eval is not installed"):
        lm_harness.make_eval_wrapper(None, None)
