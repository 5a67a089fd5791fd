"""The numbers that decide ``correct``: how far the served tokens lie from
what the reference (``reference/whisper.py``) would serve.

The decode rules are worked out here from their public definitions, not
read from the program: the prompt ``<|startoftranscript|> <|en|>
<|transcribe|> <|notimestamps|>`` at the token layout of the model's
vocabulary size, openai's ``SuppressTokens`` (the task and start tokens,
and the non-speech symbols, which in the byte-level base alphabet the
engine runs on without a vocabulary file are the single-byte ones) and
``SuppressBlank`` (" " and EOT at the first sampled position).

Numbers (each the worst over the judged requests):

* ``top1_gap``: the reference's best allowed logit minus its logit of
  the served token, at each served position (a beam's best hypothesis
  leaves the greedy path at near-ties, so beam cells print it and compare
  the next two);
* ``rank_gap`` (beam of K): how far the served token's logit lies below
  the reference's K-th best non-EOT allowed logit (an EOT: below its
  (K+1)-th best allowed logit), since beam search continues a hypothesis
  only with one of its K best non-EOT tokens or ends it with an EOT among
  its K+1 best;
* ``score_gap`` (beam): the served hypothesis' length-normalised score
  (sum of log-probabilities over its generated tokens, EOT included,
  divided by their count) against the reference's score of the same
  tokens;
* ``malformed``: judged requests whose tokens do not start with the
  prompt, hold a suppressed token, or run on past their EOT or budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from port_bench.reference.whisper import N_SAMPLES, log_mel

NONSPEECH = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    '<< >> <<< >>> -- --- -( -[ (\' (" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪'.split()
)


def specials(n_vocab: int) -> Dict[str, int]:
    """The special tokens of a multilingual Whisper vocabulary (large-v3's
    51866 carries a 100th language)."""
    eot, sot = 50257, 50258
    translate = sot + 1 + (100 if n_vocab >= 51_866 else 99)
    return {"eot": eot, "sot": sot, "en": sot + 1, "translate": translate,
            "transcribe": translate + 1, "startoflm": translate + 2, "startofprev": translate + 3,
            "nospeech": translate + 4, "notimestamps": translate + 5}


def prompt(n_vocab: int) -> List[int]:
    s = specials(n_vocab)
    return [s["sot"], s["en"], s["transcribe"], s["notimestamps"]]


def suppressed(n_vocab: int) -> List[int]:
    s = specials(n_vocab)
    ids = {s[k] for k in ("sot", "startofprev", "startoflm", "transcribe", "translate", "nospeech")}
    ids |= {ord(c) for c in NONSPEECH if len(c.encode("utf-8")) == 1}
    return sorted(ids)


class Rules:
    """Allowed tokens, on ``device``."""

    def __init__(self, n_vocab: int, device):
        s = specials(n_vocab)
        self.eot = s["eot"]
        self.n_vocab = n_vocab
        self.static = torch.zeros(n_vocab, dtype=torch.bool, device=device)
        self.static[suppressed(n_vocab)] = True
        self.blank = torch.zeros(n_vocab, dtype=torch.bool, device=device)
        self.blank[[ord(" "), self.eot]] = True

    def adjust(self, logits: torch.Tensor) -> torch.Tensor:
        """[G, V] logits for the generated positions (row 0 the first) →
        float32 logits with every disallowed token at -inf."""
        x = logits.float().masked_fill(self.static, float("-inf"))
        x[0] = x[0].masked_fill(self.blank, float("-inf"))
        return x


def _kth(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(x, k, dim=-1).values[:, -1]


def row_numbers(adj: torch.Tensor, served: torch.Tensor, eot: int, beam: int,
                score: Optional[float] = None) -> Dict[str, object]:
    """One request's readings from its adjusted reference logits ``adj``
    [G, V] and its ``served`` generated tokens [G]: the gaps at each
    position (``top1``; for beam also ``rank``) and, for beam, the score's
    distance (``score_gap``)."""
    at = adj.gather(1, served[:, None])[:, 0]
    out = {"top1": (adj.max(dim=-1).values - at).cpu()}
    if beam == 1:
        return out
    non_eot = adj.clone()
    non_eot[:, eot] = float("-inf")
    bound = torch.where(served == eot, _kth(adj, beam + 1), _kth(non_eot, beam))
    lp = torch.log_softmax(adj, dim=-1).gather(1, served[:, None])[:, 0]
    out["rank"] = torch.clamp(bound - at, min=0).cpu()
    out["score_gap"] = abs(float(lp.sum()) / len(served) - float(score))
    return out


def control_row_numbers(adj: torch.Tensor, adj_ctrl: torch.Tensor, served: torch.Tensor,
                        eot: int, beam: int) -> Dict[str, object]:
    """The same readings for a lower-precision computation of the same
    prompts and tokens (``adj_ctrl``): at each position the token it puts
    first, read against the reference; for beam, its score of the served
    tokens against the reference's."""
    lp_c = torch.log_softmax(adj_ctrl, dim=-1).gather(1, served[:, None])[:, 0]
    return row_numbers(adj, adj_ctrl.argmax(dim=-1), eot, beam,
                       score=float(lp_c.sum()) / len(served))


def summarise(rows: List[Dict[str, object]]) -> Dict[str, float]:
    """The worst gap of each kind over every judged position, with the
    share of positions with a gap and the mean gap (diagnostics), and the
    worst score gap."""
    if not rows:
        return {}
    out = {}
    for key in ("top1", "rank"):
        if key not in rows[0]:
            continue
        gaps = torch.cat([r[key] for r in rows])
        name = key + "_gap"
        out.update({name: float(gaps.max()), name + ".share": float((gaps > 0).float().mean()),
                    name + ".mean": float(gaps.mean()), "positions": float(gaps.numel())})
    if "score_gap" in rows[0]:
        out["score_gap"] = max(float(r["score_gap"]) for r in rows)
    return out


def judge(model, items: list, sizes: dict, beam: int, max_new: int, device, block: int = 4,
          control=None) -> Dict[str, float]:
    """Run the reference over each judged request and return the worst of
    each number (and, with a ``control`` model, the control's as
    ``control.<name>``). Each item: ``audio`` (1-D samples), ``crop``
    (encoder positions the decode saw, None for all), ``tokens`` (the
    served buffer, prompt first), ``length`` (valid tokens, EOT
    included) and, for beam, ``score``."""
    n_vocab = sizes["vocab_size"]
    rules = Rules(n_vocab, device)
    want = prompt(n_vocab)
    p_len = len(want)
    total = p_len + max_new
    malformed = 0
    rows, ctrl_rows = [], []

    for start in range(0, len(items), block):
        group = items[start:start + block]
        audio = np.zeros((len(group), N_SAMPLES), np.float32)
        for i, it in enumerate(group):
            n = min(len(it["audio"]), N_SAMPLES)
            audio[i, :n] = it["audio"][:n]
        mel = log_mel(torch.from_numpy(audio).to(device), sizes["num_mel_bins"])
        models = [model] + ([control] if control is not None else [])
        encs = [m.encode(mel) for m in models]
        for i, it in enumerate(group):
            toks = np.asarray(it["tokens"], np.int64)
            length = int(it["length"])
            ok = (
                list(toks[:p_len]) == want and p_len < length <= total and len(toks) >= length
                and all(t == rules.eot for t in toks[length:total])
                and (length == total or toks[length - 1] == rules.eot)
                and rules.eot not in toks[p_len:length - 1]
            )
            if not ok:
                malformed += 1
                continue
            inp = torch.from_numpy(toks[None, : length - 1]).to(device)
            served = torch.from_numpy(toks[p_len:length]).to(device)
            crop = it["crop"]
            adjs = []
            for m, enc in zip(models, encs):
                e = enc[i:i + 1] if crop is None else enc[i:i + 1, :crop]
                adjs.append(rules.adjust(m.logits(inp, e)[0, p_len - 1:]))
            if bool(torch.isinf(adjs[0].gather(1, served[:, None])).any()):
                malformed += 1  # a suppressed token was served
                continue
            rows.append(row_numbers(adjs[0], served, rules.eot, beam, it.get("score")))
            if control is not None:
                ctrl_rows.append(control_row_numbers(adjs[0], adjs[1], served, rules.eot, beam))
        del mel, encs
    out = {"malformed": float(malformed), **summarise(rows)}
    out.update({"control." + k: v for k, v in summarise(ctrl_rows).items()})
    return out

