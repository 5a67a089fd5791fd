"""Plain Uni-MoE-2.0-Omni audio-to-text path in float32 PyTorch: the
reference the served tokens of the ``uni_moe`` family are judged against.

It imports nothing of ``whisper_tpu``, ``whisper_tpu_torch`` or JAX and
takes nothing the program made: it reads the weights the harness drew
(``families/uni_moe.py``, the layout ``whisper_tpu_torch/models/audio_lm.py``
documents), the configuration file's sizes, and the clips and text ids the
harness made, and works out the rest in its own words:

* the tower: whisper.cpp's log-mel and the Whisper encoder of
  ``reference/whisper.py`` over the 30-s window;
* the audio positions: the tower's first ``whisper_audio_time`` · 50
  positions mean-pooled into ``whisper_query_tokens_size``, through the
  linear projector; a clip of n samples keeps its first ⌊n / 1600⌋
  (at least 1);
* the language model over one row at a time, no cache, no padding: every
  layer's RMSNorm, attention (q/k/v biases, GQA, rotate-half RoPE with its
  angles in float64, causal softmax), the shared experts one by one, the
  gate's softmax over the routed and null experts, the fewest of its top
  ``mlp_dynamic_top_k`` whose probabilities reach ``mlp_dynamic_top_p``,
  each chosen routed expert on its own rows weighted by its probability;
  the final RMSNorm and the untied head.

Matrix products run in float32 with TF32 off (``common/precision``), and
each layer's weights are widened to float32 as the layer runs, for every
judged row at once, so that the reference fits beside the program's
bfloat16 weights (a float32 copy of the model is 105 GB).

``operands="e4m3"`` gives the control, a precision below bfloat16: both
operands of every weight product in e4m3, the weight scaled per output
channel, the activation per tensor (the tower's too), float32 otherwise.

The routing is the reference's own, from its float32 gate, unless given.
``given=`` is the program's routing of the same positions (per layer, per
row, int8 codes [T, K]: the gate output of each slot, -1 where the slot is
not taken): the reference runs with it at every position, so that its
logits read the program's arithmetic and not a cascade of choices that
rounding decided, and counts each position where its own choice, made
``within`` or more from another choice (the margin of ``_choose``),
differs from the given set (``mismatch``; the largest such margin in
``mismatch_margin``; every differing position's margin in ``differ``).
``routing=`` (the control, tests) imposes a routing everywhere: per layer,
per row, the (experts [T, K], picked [T, K]) of each position, as ``used``
holds them after a call.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.reference.whisper import N_SAMPLES, Whisper, log_mel, scaled_e4m3

HEAD_CHUNK = 1 << 14  # head columns widened at a time


class UniMoE:
    """The reference over the harness's weight tree ``params`` and the
    configuration's sizes ``config``."""

    def __init__(self, params: dict, config: dict, operands: Optional[str] = None):
        c = config
        self.p = params
        self.fp8 = operands == "e4m3"
        self.d = c["hidden_size"]
        self.h = c["num_attention_heads"]
        self.kv = c["num_key_value_heads"]
        self.dh = self.d // self.h
        self.eps = c["rms_norm_eps"]
        self.theta = float(c["rope_theta"])
        self.n_routed = c["mlp_dynamic_expert_num"]
        self.n_shared = c["mlp_fixed_expert_num"]
        self.fs = c["shared_intermediate_size"]
        self.top_p = c["mlp_dynamic_top_p"]
        self.top_k = c["mlp_dynamic_top_k"]
        self.audio_ctx = c["whisper_audio_time"] * 50  # tower positions at 50 a second
        self.n_query = c["whisper_query_tokens_size"]
        self.per_position = 16_000 * c["whisper_audio_time"] // self.n_query  # samples
        t = c["tower"]
        heads = t["encoder_attention_heads"]
        self.tower = Whisper(params["tower"], {"encoder_attention_heads": heads,
                                               "decoder_attention_heads": heads,
                                               "num_mel_bins": t["num_mel_bins"]}, operands=operands)
        self.n_mels = t["num_mel_bins"]
        # Per layer, per row, of the last logits call: each position's margin
        # to another choice, its top probability's distance from top_p, and
        # the reference's own choice (experts, picked).
        self.margins: List[list] = []
        self.boundary: List[list] = []
        self.chosen: List[list] = []
        self.used: List[list] = []  # the routing each position ran with
        self.mismatch = 0
        self.mismatch_margin = 0.0
        self.differ: List[torch.Tensor] = []  # margins of the choices given routing differs from

    # --- precision -----------------------------------------------------------
    def _w(self, w: torch.Tensor) -> torch.Tensor:
        """A weight [..., d_in, d_out] in float32 (e4m3 per output channel
        for the control)."""
        return scaled_e4m3(w.float(), (w.dim() - 2,)) if self.fp8 else w.float()

    def _x(self, x: torch.Tensor) -> torch.Tensor:
        return scaled_e4m3(x, tuple(range(x.dim()))) if self.fp8 else x

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._x(x) @ w

    # --- audio ---------------------------------------------------------------
    def positions(self, n_samples: int) -> int:
        return int(min(max(n_samples // self.per_position, 1), self.n_query))

    def audio(self, clips: List[np.ndarray], device) -> List[torch.Tensor]:
        """Each clip's audio positions [n_i, D], float32."""
        batch = np.zeros((len(clips), N_SAMPLES), np.float32)
        for i, clip in enumerate(clips):
            n = min(len(clip), N_SAMPLES)
            batch[i, :n] = clip[:n]
        enc = self.tower.encode(log_mel(torch.from_numpy(batch).to(device), self.n_mels))
        pooled = enc[:, : self.audio_ctx].reshape(len(clips), self.n_query, -1, enc.shape[-1])
        pooled = pooled.mean(2)
        pr = self.p["projector"]
        proj = self._mm(pooled, self._w(pr["w"])) + pr["b"].float()
        return [proj[i, : self.positions(len(clip))] for i, clip in enumerate(clips)]

    def embed(self, ids) -> torch.Tensor:
        table = self.p["embed"]
        return table[torch.as_tensor(np.asarray(ids, np.int64), device=table.device)].float()

    # --- the language model ----------------------------------------------------
    def _rms(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * g.float()

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x [T, heads, Dh] at positions 0..T-1."""
        t = x.shape[0]
        inv = self.theta ** (-torch.arange(0, self.dh, 2, dtype=torch.float64) / self.dh)
        ang = torch.arange(t, dtype=torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(ang).float().to(x.device)[:, None]
        sin = torch.sin(ang).float().to(x.device)[:, None]
        x1, x2 = x[..., : self.dh // 2], x[..., self.dh // 2:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, w: dict, b: dict, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[0]
        q = (self._mm(x, w["q"]) + b["q"]).view(t, self.h, self.dh)
        k = (self._mm(x, w["k"]) + b["k"]).view(t, self.kv, self.dh)
        v = (self._mm(x, w["v"]) + b["v"]).view(t, self.kv, self.dh)
        q, k = self._rope(q), self._rope(k)
        rep = self.h // self.kv
        k = k.repeat_interleave(rep, dim=1)  # query head j reads KV head j // rep
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(self.dh)
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1),
                          float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v).reshape(t, self.d)
        return self._mm(o, w["o"])

    @staticmethod
    def _swiglu(mm, x, wg, wu, wd):
        return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)

    def _choose(self, probs: torch.Tensor):
        """The gate's choice: the top ``top_k`` sorted down, slot j taken
        while the slots before it sum below ``top_p``; and each position's
        margin (how far its probabilities lie from changing the choice: the
        top one from ``top_p``, the last taken from the first left out)."""
        top, idx = torch.topk(probs, min(self.top_k + 1, probs.shape[-1]), dim=-1)
        picked = (top[:, : self.top_k].cumsum(-1) - top[:, : self.top_k]) < self.top_p
        n = picked.sum(-1)
        last = top.gather(1, (n - 1)[:, None])[:, 0]
        after = top.gather(1, n[:, None].clamp(max=top.shape[1] - 1))[:, 0]
        boundary = (top[:, 0] - self.top_p).abs()
        return idx[:, : self.top_k], picked, torch.minimum(boundary, last - after), boundary

    def _moe(self, w: dict, x: torch.Tensor, layer: int, row: int, routing, given,
             within: float) -> torch.Tensor:
        mm = self._mm
        y = torch.zeros_like(x)
        for s in range(self.n_shared):
            cols = slice(s * self.fs, (s + 1) * self.fs)
            y = y + self._swiglu(mm, x, w["sg"][:, cols], w["su"][:, cols], w["sd"][cols])
        probs = torch.softmax(mm(x, w["gate"]), dim=-1)
        idx, picked, margin, boundary = self._choose(probs)
        self.margins[layer].append(margin)
        self.boundary[layer].append(boundary)
        self.chosen[layer].append((idx, picked))
        if routing is not None:
            idx, picked = (r.to(x.device) for r in routing[layer][row])
        elif given is not None:
            g = torch.as_tensor(np.asarray(given[layer][row]), device=x.device).long()
            mine = torch.where(picked, idx, -1).sort(-1).values
            differ = (mine != g.sort(-1).values).any(-1)
            near = margin < within
            far = differ & ~near
            self.differ.append(margin[differ])
            if bool(far.any()):
                self.mismatch += int(far.sum())
                self.mismatch_margin = max(self.mismatch_margin, float(margin[far].max()))
            idx, picked = g.clamp(min=0), g >= 0
        self.used[layer].append((idx, picked))
        for e in range(self.n_routed):
            hit = (idx == e) & picked  # [T, K]
            rows = hit.any(-1).nonzero()[:, 0]
            if rows.numel():
                p_e = (probs[rows, e])[:, None]
                y[rows] += p_e * self._swiglu(mm, x[rows], w["eg"][e], w["eu"][e], w["ed"][e])
        return y

    def _layer_weights(self, bp: dict) -> dict:
        a, s, ex = bp["attn"], bp["shared"], bp["experts"]
        return {"q": self._w(a["q"]["w"]), "k": self._w(a["k"]["w"]), "v": self._w(a["v"]["w"]),
                "o": self._w(a["o"]["w"]), "gate": self._w(bp["gate"]),
                "sg": self._w(s["w_gate"]), "su": self._w(s["w_up"]), "sd": self._w(s["w_down"]),
                "eg": [self._w(m) for m in ex["w_gate"]], "eu": [self._w(m) for m in ex["w_up"]],
                "ed": [self._w(m) for m in ex["w_down"]]}

    def logits(self, rows: List[torch.Tensor], last: List[int], routing=None, given=None,
               within: float = 0.0) -> List[torch.Tensor]:
        """Teacher-forced logits of each row's last ``last[i]`` positions,
        float32 [last_i, V]: ``rows`` are the input embeddings [T_i, D] of a
        row's whole sequence (its prefix, then its fed tokens). ``routing``,
        ``given`` and ``within``: the module's docstring."""
        xs = [r.float() for r in rows]
        self.margins, self.boundary, self.chosen, self.used = [], [], [], []
        self.mismatch, self.mismatch_margin, self.differ = 0, 0.0, []
        for li, bp in enumerate(self.p["blocks"]):
            w = self._layer_weights(bp)
            a = bp["attn"]
            b = {n: a[n]["b"].float() for n in ("q", "k", "v")}
            self.margins.append([])
            self.boundary.append([])
            self.chosen.append([])
            self.used.append([])
            for i, x in enumerate(xs):
                x = x + self._attention(w, b, self._rms(bp["attn_norm"], x))
                xs[i] = x + self._moe(w, self._rms(bp["moe_norm"], x), li, i, routing, given, within)
            del w
        outs = [self._rms(self.p["norm"], x[-n:]) for x, n in zip(xs, last)]
        head = self.p["head"]
        pieces = [[] for _ in outs]
        for c0 in range(0, head.shape[1], HEAD_CHUNK):
            wc = self._w(head[:, c0:c0 + HEAD_CHUNK])
            for i, o in enumerate(outs):
                pieces[i].append(self._mm(o, wc))
        return [torch.cat(p, dim=-1) for p in pieces]

    def boundary_share(self, within: float = 1e-3) -> float:
        """Share of the last :meth:`logits` call's (position, layer) routing
        choices whose top probability lay within ``within`` of ``top_p``."""
        dist = [d for per_row in self.boundary for d in per_row]
        total = sum(d.numel() for d in dist)
        return sum(int((d < within).sum()) for d in dist) / total if total else 0.0

    def choices(self) -> int:
        """(position, layer) routing choices of the last call."""
        return sum(m.numel() for per_row in self.margins for m in per_row)

