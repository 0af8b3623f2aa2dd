"""lm-evaluation-harness scoring for the port's MambaLMHeadModel.

Counterpart of ``fastvim_tpu/evals/lm_harness.py`` (the reference's
``evals/lm_harness_eval.py``): the scoring primitives work on their own,
and :func:`make_eval_wrapper` builds the registered ``lm_eval`` model
class, importing ``lm_eval`` only when called.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def _pad_batch(seqs: Sequence[np.ndarray], pad_id: int = 0,
               bucket: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Right-pad int sequences to one length, a multiple of ``bucket``
    (at least 2), as the JAX package pads them. Returns (tokens int32
    (n, L), lengths int32 (n,))."""
    L = max(max(len(s) for s in seqs), 2)
    L = -(-L // bucket) * bucket
    out = np.full((len(seqs), L), pad_id, np.int32)
    lens = np.zeros((len(seqs),), np.int32)
    for i, s in enumerate(seqs):
        out[i, :len(s)] = s
        lens[i] = len(s)
    return out, lens


@torch.inference_mode()
def _score(model, tokens: torch.Tensor, ctx_lens: torch.Tensor,
           total_lens: torch.Tensor):
    """Per row: the log-likelihood of tokens[ctx_len:total_len] given what
    precedes it, and whether each of those tokens is the greedy
    prediction."""
    logp = torch.log_softmax(model(tokens[:, :-1]).float(), dim=-1)
    targets = tokens[:, 1:].long()
    tok_lp = logp.gather(-1, targets[..., None])[..., 0]
    pos = torch.arange(targets.shape[1], device=tokens.device)[None]
    # the continuation is predicted at positions [ctx_len-1, total_len-1)
    mask = (pos >= ctx_lens[:, None] - 1) & (pos < total_lens[:, None] - 1)
    ll = (tok_lp * mask).sum(1)
    greedy = logp.argmax(-1) == targets
    return ll, torch.where(mask, greedy, True).all(1)


def loglikelihood(model, pairs: Sequence[Tuple[Sequence[int],
                                               Sequence[int]]],
                  batch_size: int = 16) -> List[Tuple[float, bool]]:
    """lm_eval ``loglikelihood``: (context tokens, continuation tokens)
    pairs → [(summed log-probability of the continuation, is_greedy)], in
    batches of ``batch_size`` on the model's device."""
    device = next(model.parameters()).device
    results: List[Tuple[float, bool]] = []
    for i in range(0, len(pairs), batch_size):
        chunk = pairs[i:i + batch_size]
        seqs = [np.asarray(list(c) + list(x), np.int32) for c, x in chunk]
        ctx_lens = np.asarray([max(len(c), 1) for c, _ in chunk], np.int32)
        tokens, total = _pad_batch(seqs)
        ll, greedy = _score(model, *(torch.from_numpy(a).to(device)
                                     for a in (tokens, ctx_lens, total)))
        results.extend((float(a), bool(b))
                       for a, b in zip(ll.cpu().numpy(),
                                       greedy.cpu().numpy()))
    return results


def rolling_windows(tokens: Sequence[int], max_seq_len: int,
                    prefix_token: int) -> List[Tuple[List[int], List[int]]]:
    """A document's rolling prediction windows, as lm_eval's
    ``get_rolling_token_windows(..., context_len=1)`` followed by
    ``make_disjoint_window`` gives them: every token predicted once, the
    first window from the prefix (EOT) token, each full later window from
    the token before it, the last partial window with the longer trimmed
    context the disjoint transform leaves."""
    toks = list(tokens)
    n = len(toks)
    if n == 0:
        return []
    first = min(max_seq_len, n)
    out = [([prefix_token], toks[:first])]
    done = first
    while done < n:
        plen = min(n - done, max_seq_len)
        end = done + plen
        out.append((toks[end - max_seq_len - 1:end - plen],
                    toks[end - plen:end]))
        done = end
    return out


def loglikelihood_rolling(model, token_lists: Sequence[Sequence[int]],
                          batch_size: int = 16,
                          max_seq_len: Optional[int] = None,
                          prefix_token: int = 0) -> List[float]:
    """lm_eval ``loglikelihood_rolling``: the log-likelihood of every token
    of each document, the first predicted from ``prefix_token``, summed
    over disjoint windows of at most ``max_seq_len`` predictions (one
    window when None): a document longer than the context is scored in
    full."""
    pairs: List[Tuple[List[int], List[int]]] = []
    spans: List[Tuple[int, int]] = []
    for t in token_lists:
        wins = rolling_windows(t, max_seq_len or max(len(t), 1),
                               prefix_token)
        spans.append((len(pairs), len(pairs) + len(wins)))
        pairs.extend(wins)
    lls = loglikelihood(model, pairs, batch_size)
    return [float(sum(ll for ll, _ in lls[a:b])) for a, b in spans]


def make_eval_wrapper(model, tokenizer, max_length: int = 2048,
                      batch_size: int = 16):
    """Build and register (as ``fastvim_mamba``) the lm_eval ``LM``
    subclass over ``model``. Needs the ``lm_eval`` package, and raises
    ImportError without it."""
    try:
        from lm_eval.api.model import LM
        from lm_eval.api.registry import register_model
    except ImportError as e:
        raise ImportError(
            "lm_eval is not installed; the scoring primitives "
            "(loglikelihood / loglikelihood_rolling) work standalone"
        ) from e

    class MambaEvalWrapper(LM):
        def __init__(self):
            super().__init__()
            self.tokenizer = tokenizer
            self._max_length = max_length

        def _enc(self, s):
            return self.tokenizer.encode(s)

        def loglikelihood(self, requests):
            pairs = []
            for req in requests:
                ctx, cont = req.args
                c = self._enc(ctx) or [getattr(self.tokenizer,
                                               "eos_token_id", 0)]
                pairs.append((c[-self._max_length:], self._enc(cont)))
            return loglikelihood(model, pairs, batch_size)

        def loglikelihood_rolling(self, requests):
            toks = [self._enc(req.args[0]) for req in requests]
            return loglikelihood_rolling(
                model, toks, batch_size, max_seq_len=self._max_length,
                prefix_token=getattr(self.tokenizer, "eos_token_id", 0))

        def generate_until(self, requests):
            from fastvim_tpu_torch.models.lm import generate

            device = next(model.parameters()).device
            outs = []
            for req in requests:
                ctx, kwargs = req.args
                prompt = torch.tensor(
                    [self._enc(ctx)[-self._max_length:]], device=device)
                toks = generate(model, prompt,
                                kwargs.get("max_gen_toks", 128),
                                temperature=0.0)
                text = self.tokenizer.decode(
                    toks[0, prompt.shape[1]:].tolist())
                for stop in kwargs.get("until", []):
                    text = text.split(stop)[0]
                outs.append(text)
            return outs

    register_model("fastvim_mamba")(MambaEvalWrapper)
    return MambaEvalWrapper
