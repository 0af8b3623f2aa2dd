"""Mamba language model and autoregressive generation.

Counterpart of ``fastvim_tpu/models/lm.py`` (the reference's
``MambaLMHeadModel`` and its sampler): an embedding, ``n_layer`` blocks
of add + RMSNorm and a unidirectional Mamba mixer, a final norm, and an
LM head tied to the embedding, over a vocabulary padded to
``pad_vocab_multiple``. Parameters carry the reference's (Hugging Face)
names: ``backbone.embedding.weight``, ``backbone.layers.{i}.norm.weight``,
``backbone.layers.{i}.mixer.{in_proj,conv1d,x_proj,dt_proj,out_proj}.*``,
``...mixer.A_log``, ``...mixer.D`` and ``backbone.norm_f.weight``; they
stay float32 and are cast to the model's ``dtype`` where they are used.

Three forms of the forward pass:

* the full sequence, logits only;
* ``prefill=True``: the full sequence, which also returns each layer's
  decode cache (the conv window, the last ``d_conv`` inputs of the conv,
  and the scan's final state). One scan a layer gives both: on the card
  one launch of K1 with the gate and the final state in its epilogue;
* ``caches=...``: one token through each layer's cached step (conv
  window update, ``selective_state_update``), plain torch.

:func:`generate` prefills the prompt and then decodes token by token in a
host loop. The JAX package compiles prefill and decode loop into one
program; capturing the step in a CUDA graph is the port's counterpart,
not done yet.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from fastvim_tpu_torch.models.layers import (
    a_log_init_,
    dt_bias_init_,
    dt_proj_weight_init_,
    torch_linear_init_,
)
from fastvim_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_update
from fastvim_tpu_torch.ops.norms import add_norm
from fastvim_tpu_torch.ops.scan import selective_scan
from fastvim_tpu_torch.ops.state_update import selective_state_update

Cache = Tuple[torch.Tensor, torch.Tensor]


class MambaLM(nn.Module):
    """The unidirectional Mamba mixer of the language model (the JAX
    package's ``MambaLM``; the reference's ``mamba_simple.Mamba``)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, dt_rank: Union[int, str] = "auto",
                 n_layer: int = 24, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.d_state, self.d_conv = d_model, d_state, d_conv
        self.d_inner = int(expand * d_model)
        self.dt_rank = (-(-d_model // 16) if dt_rank == "auto"
                        else int(dt_rank))
        self.n_layer = n_layer
        self.dtype = dtype
        di, n, r = self.d_inner, d_state, self.dt_rank
        self.in_proj = skip_init(nn.Linear, d_model, 2 * di, bias=False)
        self.conv1d = skip_init(nn.Conv1d, di, di, d_conv, groups=di,
                                bias=True)
        self.x_proj = skip_init(nn.Linear, di, r + 2 * n, bias=False)
        self.dt_proj = skip_init(nn.Linear, r, di, bias=True)
        self.A_log = nn.Parameter(torch.empty(di, n))
        self.D = nn.Parameter(torch.ones(di))
        self.out_proj = skip_init(nn.Linear, di, d_model, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init (``models/layers.py``), drawn from
        ``generator``."""
        di = self.d_inner
        torch_linear_init_(self.in_proj.weight, self.d_model, generator)
        torch_linear_init_(self.conv1d.weight, self.d_conv, generator)
        torch_linear_init_(self.conv1d.bias, self.d_conv, generator)
        torch_linear_init_(self.x_proj.weight, di, generator)
        dt_proj_weight_init_(self.dt_proj.weight, self.dt_rank, generator)
        dt_bias_init_(self.dt_proj.bias, generator)
        a_log_init_(self.A_log)
        nn.init.ones_(self.D)
        torch_linear_init_(self.out_proj.weight, di, generator,
                           scale=1 / math.sqrt(self.n_layer))

    def init_cache(self, batch: int,
                   device: Optional[torch.device] = None) -> Cache:
        """A zero decode cache: (conv window (batch, d_conv, d_inner),
        ssm state (batch, d_inner, d_state)), both fp32."""
        device = device if device is not None else self.A_log.device
        return (torch.zeros(batch, self.d_conv, self.d_inner, device=device),
                torch.zeros(batch, self.d_inner, self.d_state, device=device))

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                return_cache: bool = False):
        """x: (batch, L, d_model). Returns (out, new_cache). With
        ``cache``, L must be 1 (one decode step). Without it,
        ``return_cache`` is the prefill: the cache after the sequence, its
        conv window the last d_conv inputs (zero-padded in front when L <
        d_conv) and its ssm state the scan's last state; else the cache is
        None."""
        dtype = self.dtype
        di, n, r = self.d_inner, self.d_state, self.dt_rank
        xz = F.linear(x.to(dtype), self.in_proj.weight.to(dtype))
        xin, z = xz[..., :di], xz[..., di:]
        conv_w = self.conv1d.weight.squeeze(1).t().to(dtype)  # (w, di)
        conv_b = self.conv1d.bias.to(dtype)
        A = -torch.exp(self.A_log.float())
        if cache is None:
            xc = causal_conv1d(xin, conv_w, conv_b)
            dbl = F.linear(xc, self.x_proj.weight.to(dtype))
            dt = F.linear(dbl[..., :r], self.dt_proj.weight.to(dtype))
            out = selective_scan(
                xc, dt, A, dbl[..., r:r + n].contiguous(),
                dbl[..., r + n:].contiguous(), D=self.D,
                delta_bias=self.dt_proj.bias, delta_softplus=True, z=z,
                return_last_state=return_cache)
            if return_cache:
                y, last = out
                L = xin.shape[1]
                win = xin[:, max(L - self.d_conv, 0):].float()
                win = F.pad(win, (0, 0, self.d_conv - win.shape[1], 0))
                new_cache = (win, last)
            else:
                y, new_cache = out, None
        else:
            conv_state, ssm_state = cache
            xc, conv_state = causal_conv1d_update(xin[:, 0], conv_state,
                                                  conv_w, conv_b)
            # the step runs in the window's type (fp32), as in the JAX
            # package, whose dot products promote to it
            pt = xc.dtype
            dbl = F.linear(xc, self.x_proj.weight.to(pt))
            dt = F.linear(dbl[:, :r], self.dt_proj.weight.to(pt))
            y1, ssm_state = selective_state_update(
                ssm_state, xc, dt, A, dbl[:, r:r + n], dbl[:, r + n:],
                D=self.D, z=z[:, 0], dt_bias=self.dt_proj.bias,
                dt_softplus=True)
            y = y1[:, None]
            new_cache = (conv_state, ssm_state)
        return F.linear(y.to(dtype), self.out_proj.weight.to(dtype)), \
            new_cache


class _NormWeight(nn.Module):
    """The weight of an RMSNorm (LayerNorm without bias with
    ``rms_norm=False``); the norm itself is ``ops.norms.add_norm``."""

    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class _Block(nn.Module):
    def __init__(self, d_model: int, mixer: MambaLM):
        super().__init__()
        self.norm = _NormWeight(d_model)
        self.mixer = mixer


class _Backbone(nn.Module):
    def __init__(self, vocab: int, d_model: int, layers: List[_Block]):
        super().__init__()
        self.embedding = nn.Embedding(vocab, d_model)
        self.layers = nn.ModuleList(layers)
        self.norm_f = _NormWeight(d_model)


class MambaLMHeadModel(nn.Module):
    """Embedding → n_layer × (add + norm → MambaLM) → norm → tied LM head
    (the JAX package's ``MambaLMHeadModel``; its defaults are mamba-130m's
    published widths)."""

    def __init__(self, vocab_size: int = 50277, d_model: int = 768,
                 n_layer: int = 24, d_state: int = 16, rms_norm: bool = True,
                 norm_eps: float = 1e-5, pad_vocab_multiple: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.vocab_size, self.d_model, self.n_layer = (vocab_size, d_model,
                                                       n_layer)
        self.d_state = d_state
        self.rms_norm, self.norm_eps = rms_norm, norm_eps
        self.pad_vocab_multiple = pad_vocab_multiple
        self.dtype = dtype
        self.backbone = _Backbone(self.padded_vocab, d_model, [
            _Block(d_model, MambaLM(d_model, d_state=d_state,
                                    n_layer=n_layer, dtype=dtype))
            for _ in range(n_layer)])

    @property
    def padded_vocab(self) -> int:
        m = self.pad_vocab_multiple
        return -(-self.vocab_size // m) * m

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Embedding N(0, 0.02), norms 1, each mixer as
        :meth:`MambaLM.reset_parameters`, drawn from ``generator``."""
        bb = self.backbone
        with torch.no_grad():
            bb.embedding.weight.normal_(0.0, 0.02, generator=generator)
        for layer in bb.layers:
            nn.init.ones_(layer.norm.weight)
            layer.mixer.reset_parameters(generator)
        nn.init.ones_(bb.norm_f.weight)

    def init_cache(self, batch: int,
                   device: Optional[torch.device] = None) -> List[Cache]:
        """Zero decode caches, one per layer."""
        return [layer.mixer.init_cache(batch, device)
                for layer in self.backbone.layers]

    def forward(self, tokens: torch.Tensor,
                caches: Optional[List[Cache]] = None,
                prefill: bool = False):
        """tokens (batch, L) integer → logits (batch, L, padded vocab),
        float32. With ``caches`` (one per layer), one decode step (L = 1)
        returning ``(logits, new_caches)``; with ``prefill=True`` the full
        sequence returning ``(logits, caches)`` for decoding on from it.
        The caches passed in are not modified."""
        bb = self.backbone
        hidden = bb.embedding(tokens).to(self.dtype)
        residual = None
        new_caches = []
        for i, layer in enumerate(bb.layers):
            hidden, residual = add_norm(
                hidden, layer.norm.weight, None, residual=residual,
                prenorm=True, rms=self.rms_norm, eps=self.norm_eps,
                out_dtype=self.dtype)
            hidden, cache = layer.mixer(
                hidden, None if caches is None else caches[i],
                return_cache=prefill)
            new_caches.append(cache)
        hidden = add_norm(hidden, bb.norm_f.weight, None, residual=residual,
                          rms=self.rms_norm, eps=self.norm_eps,
                          out_dtype=self.dtype)
        emb = bb.embedding.weight
        logits = F.linear(hidden.to(emb.dtype), emb)
        if caches is not None or prefill:
            return logits, new_caches
        return logits


def create_lm(device: Union[str, torch.device, None] = None,
              generator: Optional[torch.Generator] = None,
              **fields) -> MambaLMHeadModel:
    """A :class:`MambaLMHeadModel` with ``fields`` (mamba-130m's widths by
    default), initialized on the CPU from ``generator`` (seed 0 if None),
    moved to ``device`` and in eval mode. ``device=None`` means the first
    CUDA device and raises where there is none: the CPU is used only when
    asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_lm: no CUDA device; pass device='cpu' "
                               "to build the model on the CPU")
        device = torch.device("cuda", 0)
    model = MambaLMHeadModel(**fields)
    model.reset_parameters(generator if generator is not None
                           else torch.Generator().manual_seed(0))
    return model.to(device).eval()


def prepare_logits(logits: torch.Tensor, temperature: float = 1.0,
                   top_k: Optional[int] = None, top_p: float = 0.0,
                   repetition_penalty: float = 1.0,
                   seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The sampler's logit pipeline, as the JAX package's
    ``prepare_logits`` (the reference's ``utils/generation.py``), in fp32:

    1. the repetition penalty (CTRL) over every token seen so far, prompt
       and generated, given as a presence mask ``seen`` (batch, vocab)
       bool: negative logits × penalty, the others ÷ penalty;
    2. top-k: all below the k-th largest to -inf;
    3. temperature;
    4. top-p: the smallest logits whose softmax mass sums to at most
       1 - p, by the ascending cumulative sum, to -inf (the largest is
       always kept), within the top-k survivors.
    """
    logits = logits.float()
    if repetition_penalty != 1.0 and seen is not None:
        penalized = torch.where(logits < 0, logits * repetition_penalty,
                                logits / repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if top_k is not None and top_k > 0:
        kth = torch.topk(logits, min(top_k, logits.shape[-1])).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    if temperature != 1.0:
        logits = logits / temperature
    if 0.0 < top_p < 1.0:
        srt = torch.sort(logits, dim=-1).values  # ascending
        cum = torch.softmax(srt, dim=-1).cumsum(-1)
        kept = cum > 1.0 - top_p  # a suffix; the top-1 always kept
        thresh = torch.where(kept, srt, math.inf).amin(-1, keepdim=True)
        logits = logits.masked_fill(logits < thresh, -math.inf)
    return logits


@torch.inference_mode()
def generate(model: MambaLMHeadModel, prompt: torch.Tensor,
             max_new_tokens: int, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: float = 0.0,
             repetition_penalty: float = 1.0,
             eos_token_id: Optional[int] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Prompt (batch, L) integer tokens on the model's device → (batch, L +
    max_new_tokens) in the prompt's dtype: the prefill, then one cached
    step a token. Greedy when ``temperature == 0`` or ``top_k == 1``;
    otherwise :func:`prepare_logits` and a draw from ``generator`` (a
    ``torch.Generator`` on the model's device; seed 0 there if None).
    With ``eos_token_id`` every position of a row after its first eos is
    eos; the loop stops once every row has one and fills the rest."""
    batch = prompt.shape[0]
    greedy = temperature == 0.0 or top_k == 1
    if generator is None and not greedy:
        generator = torch.Generator(device=prompt.device).manual_seed(0)
    logits, caches = model(prompt, prefill=True)
    cur = logits[:, -1]
    rows = torch.arange(batch, device=prompt.device)
    seen = None
    if repetition_penalty != 1.0:
        seen = torch.zeros(batch, cur.shape[-1], dtype=torch.bool,
                           device=prompt.device)
        seen[rows[:, None], prompt.long()] = True
    done = (None if eos_token_id is None else
            torch.zeros(batch, dtype=torch.bool, device=prompt.device))
    out = [prompt]
    for t in range(max_new_tokens):
        if greedy:
            nxt = cur.argmax(-1)
        else:
            probs = torch.softmax(prepare_logits(
                cur, temperature, top_k, top_p, repetition_penalty, seen),
                dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        if done is not None:
            nxt = torch.where(done, eos_token_id, nxt)
            done = done | (nxt == eos_token_id)
        if seen is not None:
            seen[rows, nxt] = True
        nxt = nxt.to(prompt.dtype)[:, None]
        out.append(nxt)
        left = max_new_tokens - 1 - t
        if left == 0:
            break
        if done is not None and bool(done.all()):
            out.append(torch.full((batch, left), eos_token_id,
                                  dtype=prompt.dtype, device=prompt.device))
            break
        step_logits, caches = model(nxt, caches=caches)
        cur = step_logits[:, -1]
    return torch.cat(out, 1)
