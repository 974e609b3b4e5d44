"""Decode on one card for a chat or agent service: ``batch`` live
sessions, each with a ``context``-token history, taking short turns of
greedy tokens through the program's latent-cache decode step
(``models/deepseek_v3.py::decode_step``).

Set-up draws the model from the seed one parameter at a time
(``reference.Drawn``: no more than one float32 linear is ever held) and
the program converts and packs each linear as it is drawn (``convert``
with ``pack_fmt``); it then prefills every session's ``context`` Zipf
ids through the program's prefill (chunks of about ``prefill_rows``
tokens) into the preallocated latent cache, and warms the step over one
whole turn.  Each unit is one greedy decode step of
every session at one position; after ``steps`` steps a turn ends:
positions go back to ``context`` and every session starts a new turn
from a first token drawn from the seed, so attention always sees
``context`` + 1 .. ``context + steps`` entries.

Checked after the window, on a sample: ``check_rows`` sessions and the
first dense layer plus ``check_layers`` expert layers, all drawn from the
seed; the prefill and ``check_turns`` turns of the window.  The program's
forward takes a context that records, for the sampled sessions and
layers, each layer's input and output, the cache entries it wrote and
the experts it selected, and the final hidden (``Context.record``); the
reference steps each sampled layer from those inputs and the program's
cache (``reference.follow``).
"""

from __future__ import annotations

import functools
import json
import sys

import numpy as np
import torch

from benchmark.harness import Reservoir, generator, sub_seed
from benchmark.reference import deepseek_v3 as ref

READINGS = ("weight_mismatch", "route_mismatch", "route_near", "layer_gap",
            "cache_gap", "logit_gap")


def recording_context(store: list, rows: list[int], layers: list[int]):
    """A ``Context`` class that keeps, in the dict ``store[0]`` while it
    is one, the sampled ``rows``' records of the sampled ``layers`` and
    the final hidden, each name's pieces in a list."""
    from tq_tpu_torch.models.deepseek_v3 import Context

    wanted = {f"layers.{i}.{part}" for i in layers
              for part in ("input", "output", "latent", "mlp.gate")}
    wanted.add("norm")

    class Recording(Context):
        def record(self, name, value, span):
            if store[0] is None or name not in wanted:
                return
            lo = span.start or 0
            pick = [r - lo for r in rows if lo <= r < lo + value.shape[0]]
            if pick:
                store[0].setdefault(name, []).append(value[pick])

    return Recording


class Loop:
    def __init__(self, run):
        self.run = run
        self.cfg, self.traffic = run.cfg, run.traffic
        self.rows = self.traffic["batch"]
        self.units = self.steps = self.attempted = self.failed = 0

    def _first(self, *tags: int) -> torch.Tensor:
        """Every session's first token, drawn from the seed's part
        ``tags``."""
        rng = np.random.default_rng(sub_seed(self.run.seed, *tags))
        ids = rng.integers(0, self.cfg["vocab_size"], self.rows,
                           dtype=np.int64)
        return torch.as_tensor(ids, device=self.run.device)

    def setup(self) -> None:
        from tq_tpu_torch.layers.moe import moe_apply
        from tq_tpu_torch.models import deepseek_v3 as dsv3

        cfg, tf, dev, seed = self.cfg, self.traffic, self.run.device, \
            self.run.seed
        rng = np.random.default_rng(sub_seed(seed, 3))
        L = cfg["num_hidden_layers"]
        experts = [i for i in range(L) if ref.is_moe(cfg, i)]
        picked = rng.choice(experts, tf["check_layers"], replace=False)
        self.layers = sorted([next(i for i in range(L)
                                   if not ref.is_moe(cfg, i))]
                             + [int(i) for i in picked])
        self.check = sorted(int(r) for r in rng.choice(
            self.rows, tf["check_rows"], replace=False))
        tr, srv = cfg["tr"], cfg["serving"]
        setting = (tr["weight_bits"], tr["group_size"], tr["weight_terms"],
                   tr["data_bits"], tr["data_terms"])
        self.qparams, qcfg, qstate = dsv3.convert(
            ref.Drawn(cfg, seed, dev), cfg, setting,
            quantize_input=srv["quantize_input"], pack_fmt=srv["pack"])
        T = tf["context"]
        self.cache = dsv3.init_cache(cfg, self.rows, T + tf["steps"], dev)
        prompts = ref.zipf_ids(cfg, generator(seed, dev, 2), (self.rows, T),
                               dev)
        self._store = [{}]
        ctx = recording_context(self._store, self.check,
                                self.layers)(qcfg, qstate)
        dsv3.prefill(self.qparams, cfg, prompts, self.cache, ctx=ctx,
                     chunk_rows=tf["prefill_rows"])
        self.prefill = {k: torch.cat(v) for k, v in self._store[0].items()}
        self._store[0] = None
        self.step = functools.partial(dsv3.decode_step, self.qparams, cfg,
                                      cache=self.cache, ctx=ctx)
        tok = self._first(6)
        for pos in range(T, T + tf["steps"]):  # every attention length
            tok = self.step(tok, pos).argmax(-1)
        self._turn_step, self.turns, self._turn = tf["steps"], 0, None
        self.kept = Reservoir(tf["check_turns"], seed)
        moe_apply.counts.clear()

    def unit(self) -> None:
        tf = self.traffic
        if self._turn_step == tf["steps"]:
            self._tok = self._first(5, self.turns)
            self._turn_step, self._turn = 0, None
            self.turns += 1
            if self.kept.wants():
                self._turn = []
                self.kept.put(self._turn)
        pos = tf["context"] + self._turn_step
        if self._turn is not None:
            self._store[0] = {}
        logp = self.step(self._tok, pos)
        self._tok = logp.argmax(-1)
        if self._turn is not None:
            rec = {k: v[0] for k, v in self._store[0].items()}
            rec["logp"], rec["pos"] = logp[self.check], pos
            self._turn.append(rec)
            self._store[0] = None
        self._turn_step += 1
        self.units += 1
        self.steps += 1
        self.attempted += self.rows

    def drain(self) -> None:
        self.run.spans.sync()

    def end_to_end(self, seconds: float) -> dict:
        return {"tokens_per_s": (self.steps * self.rows / seconds,
                                 "tokens/s")}

    def release(self) -> None:
        """Keep the sampled layers' and ``lm_head``'s served weights and
        the sampled sessions' prefilled cache entries; print the expert
        layers' counts a step."""
        from tq_tpu_torch.layers.moe import moe_apply

        names = [n for i in self.layers for n in ref.layer_shapes(self.cfg, i)
                 if ref.is_linear(n)] + ["lm_head"]
        self.weights = {n: self.qparams[n] for n in names}
        T = self.traffic["context"]
        self.prefill_cache = [self.cache[i, self.check, :T].clone()
                              for i in self.layers]
        counts = list(moe_apply.counts.values())
        calls = sum(c["calls"] for c in counts)
        if calls and self.steps:
            print("benchmark: moe.counts a step: " + json.dumps(
                {"layers": len(counts),
                 "tokens": sum(c["tokens"] for c in counts) / self.steps,
                 "max_load": max(c["max_load"] for c in counts),
                 "stream": sum(c["stream"] for c in counts) / self.steps,
                 "mma": sum(c["mma"] for c in counts) / self.steps}),
                file=sys.stderr)
        del self.qparams, self.cache, self.step

    def _mismatch(self, w: dict, names) -> int:
        """Weights of ``names`` where the program's served ones, decoded
        from the 9-bit pack by the reference, differ from the reference's
        term reveal; ``kv_b_proj``'s absorbed heads too."""
        cfg, n = self.cfg, 0
        H, nope, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["kv_lora_rank"])
        for name in names:
            want = w[name]["w"]
            got = self.weights[name]
            if not hasattr(got["w"], "lo"):
                n += want.numel()
                continue
            dec = ref.unpack_u8s(got["w"].lo, got["w"].signs,
                                 got["w"].w_sf, want.shape[0])
            n += int((dec != want).sum()) if dec.shape == want.shape \
                else want.numel()
            if name.endswith(".kv_b_proj"):
                heads = want.reshape(r, H, -1)
                for key, part in (("wk", heads[:, :, :nope].permute(1, 2, 0)),
                                  ("wv", heads[:, :, nope:].permute(1, 0, 2))):
                    have = got.get(key)
                    n += (part.numel() if have is None
                          or have.shape != part.shape
                          else int((have != part).sum()))
        return n

    def readings(self, control: bool = False) -> dict:
        """``weight_mismatch``; the most ``layer_gap`` and ``cache_gap``
        and the summed ``route_mismatch`` and ``route_near`` of the
        sampled layers over the prefill and each sampled turn's steps
        (``reference.follow``); ``logit_gap`` of each sampled step
        (``reference.follow_head``).  With ``control`` the reference at
        TF32 takes the program's place (its weights are the reference's
        own)."""
        cfg, dev, seed = self.cfg, self.run.device, self.run.seed
        turns = [t for t in self.kept.items if t]
        if not turns or not self.prefill:
            return dict.fromkeys(READINGS, float("inf"))
        found = dict.fromkeys(READINGS, 0.0)

        def add(f):
            for k in ("layer_gap", "cache_gap"):
                found[k] = max(found[k], f[k])
            for k in ("route_mismatch", "route_near"):
                found[k] += f[k]

        for j, i in enumerate(self.layers):
            names = list(ref.layer_shapes(cfg, i))
            w = ref.convert(cfg, seed, names, dev)
            if not control:
                found["weight_mismatch"] += self._mismatch(
                    w, [n for n in names if ref.is_linear(n)])
            pre = f"layers.{i}"
            gate = self.prefill.get(f"{pre}.mlp.gate")
            add(ref.follow(w, cfg, i, self.prefill.get(f"{pre}.input"),
                           self.prefill.get(f"{pre}.output"),
                           self.prefill_cache[j], gate, control=control))
            for turn in turns:
                written = []
                for rec in turn:
                    sel = rec.get(f"{pre}.mlp.gate")
                    entry = rec.get(f"{pre}.latent")
                    x, out = rec.get(f"{pre}.input"), rec.get(f"{pre}.output")
                    if x is None or out is None or entry is None:
                        add(ref.follow(w, cfg, i, None, None, None, None))
                        break
                    prev = torch.cat([self.prefill_cache[j]] + written, 1)
                    add(ref.follow(w, cfg, i, x[:, None], out[:, None],
                                   entry[:, None],
                                   None if sel is None else sel[:, None],
                                   prev, rec["pos"], control))
                    written.append(entry[:, None])
            del w
        w = ref.convert(cfg, seed, ["norm", "lm_head"], dev)
        if not control:
            found["weight_mismatch"] += self._mismatch(w, ["lm_head"])
        for turn in turns:
            for rec in turn:
                found["logit_gap"] = max(found["logit_gap"], ref.follow_head(
                    w, cfg, rec["norm"], rec["logp"], control))
        return found
