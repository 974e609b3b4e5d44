"""Decode on one card of a 4-card Kimi-Linear host for a chat or agent
service whose turns are retried or resumed from saved state: ``batch``
live sessions, each with a ``context``-token history, taking turns of
``steps`` greedy tokens through the program's hybrid-cache decode step
(``models/kimi_linear.py::decode_step``), every turn starting from the
sessions' state after the history.

Set-up draws the model from the seed one parameter at a time
(``reference.Drawn``: no more than one float32 linear is ever held) and
the program converts and packs each linear as it is drawn (``convert``
with ``pack_fmt``); it then prefills every session's ``context`` Zipf
ids through the program's chunked prefill (chunks of about
``prefill_rows`` tokens) into the preallocated cache, takes one
:func:`snapshot` of the KDA state and tails, and warms the step over one
whole turn.  Each unit is one greedy decode step of every
session at one position; after ``steps`` steps a turn ends: positions go
back to ``context``, :func:`restore` copies every session's KDA state and
tails back from the snapshot (in the window), and every session starts a
new turn from a first token drawn from the seed.

Checked after the window, on a sample: ``check_rows`` sessions; the
first layer (KDA, dense), ``check_kda_layers`` KDA expert layers and
``check_mla_layers`` MLA layers, all drawn from the seed; the prefill
and ``check_turns`` turns of the window.  The program's forward takes a
context that records, for the sampled sessions and layers, each layer's
input and output, the latent entries it wrote and the experts it
selected, and the final hidden; the loop keeps the sampled sessions' KDA
state and tails after the prefill (the snapshot's) and at the end of
each sampled turn, and counts, after every restore, the sampled
sessions' state and tail values that differ from the snapshot's
(``restore_mismatch``).  The reference steps each sampled layer from
those inputs and the program's state and cache (``reference.follow_kda``,
``.follow_mla``).

The benchmark runs only on a card (``run.py`` refuses without one).  On
a CPU device, which only the benchmark's CPU tests give it, the loop
runs :data:`CPU_SIZES` and :data:`CPU_TRAFFIC`, a tiny instance of the
same configuration: the same program, reference, checks and limits.
"""

from __future__ import annotations

import functools
import json
import sys

import numpy as np
import torch

from benchmark.harness import Reservoir, generator, sub_seed
from benchmark.loops.moe_decode import recording_context
from benchmark.reference import kimi_linear as ref

READINGS = ("weight_mismatch", "route_mismatch", "route_near", "layer_gap",
            "state_gap", "cache_gap", "logit_gap", "restore_mismatch")

# Hidden 64; 8 layers in the published pattern (KDA 4 heads of 16, NoPE
# MLA 4 heads, latent 32); a router of 16 experts of width 32, top 4, 4
# held; vocab 211.
CPU_SIZES = {
    "hidden_size": 64, "num_hidden_layers": 8, "vocab_size": 211,
    "linear_attn_config": {"full_attn_layers": [4, 8], "head_dim": 16,
                           "kda_layers": [1, 2, 3, 5, 6, 7],
                           "num_heads": 4, "short_conv_kernel_size": 4},
    "num_attention_heads": 4, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "kv_lora_rank": 32, "intermediate_size": 96,
    "moe_intermediate_size": 32, "num_experts": 4, "router_experts": 16,
    "num_experts_per_token": 4,
}
CPU_TRAFFIC = {"batch": 4, "context": 20, "steps": 3, "prefill_rows": 40,
               "check_rows": 2}


class Loop:
    def __init__(self, run):
        self.run = run
        if run.device.type == "cpu":
            run.cfg.update(CPU_SIZES)
            run.traffic.update(CPU_TRAFFIC)
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

    def _sample_layers(self, rng) -> list[int]:
        cfg, tf = self.cfg, self.traffic
        L = cfg["num_hidden_layers"]
        kda = [i for i in range(L)
               if ref.is_kda(cfg, i) and ref.is_moe(cfg, i)]
        mla = [i for i in range(L) if not ref.is_kda(cfg, i)]
        picked = (list(rng.choice(kda, tf["check_kda_layers"],
                                  replace=False))
                  + list(rng.choice(mla, tf["check_mla_layers"],
                                    replace=False)))
        return sorted([0] + [int(i) for i in picked])

    def setup(self) -> None:
        from tq_tpu_torch.layers.moe import moe_apply
        from tq_tpu_torch.models import kimi_linear as kimi

        cfg, tf, dev, seed = self.cfg, self.traffic, self.run.device, \
            self.run.seed
        rng = np.random.default_rng(sub_seed(seed, 3))
        self.layers = self._sample_layers(rng)
        self.check = sorted(int(r) for r in rng.choice(
            self.rows, tf["check_rows"], replace=False))
        tr, srv = cfg["tr"], cfg["serving"]
        setting = (tr["weight_bits"], tr["group_size"], tr["weight_terms"],
                   tr["data_bits"], tr["data_terms"])
        self.qparams, qcfg, qstate = kimi.convert(
            ref.Drawn(cfg, seed, dev), cfg, setting,
            quantize_input=srv["quantize_input"], pack_fmt=srv["pack"])
        T = tf["context"]
        self.cache = kimi.init_cache(cfg, self.rows, T + tf["steps"], dev)
        prompts = ref.zipf_ids(cfg, generator(seed, dev, 2), (self.rows, T),
                               dev)
        self._store = [{}]
        ctx = recording_context(self._store, self.check,
                                self.layers)(qcfg, qstate)
        kimi.prefill(self.qparams, cfg, prompts, self.cache, ctx=ctx,
                     chunk_rows=tf["prefill_rows"])
        self.prefill = {k: torch.cat(v) for k, v in self._store[0].items()}
        self._store[0] = None
        self.snap = kimi.snapshot(self.cache)
        self._restore = functools.partial(kimi.restore, self.cache, self.snap)
        self.step = functools.partial(kimi.decode_step, self.qparams, cfg,
                                      cache=self.cache, ctx=ctx)
        self._kda = [i for i in self.layers if ref.is_kda(cfg, i)]
        self._rows_t = torch.tensor(self.check, device=dev)
        self._restore_bad = torch.zeros((), dtype=torch.int64, device=dev)
        tok = self._first(6)
        for pos in range(T, T + tf["steps"]):  # every attention length
            tok = self.step(tok, pos).argmax(-1)
        self._turn_step, self.turns, self._turn = tf["steps"], 0, None
        self.kept = Reservoir(tf["check_turns"], seed)
        moe_apply.counts.clear()

    def _kda_now(self, state, conv) -> dict:
        """The sampled sessions' state and tail of the sampled KDA
        layers, copied."""
        out = {}
        for i in self._kda:
            j = self.cache.slots[i]
            out[i] = (state[j].index_select(0, self._rows_t),
                      conv[j].index_select(0, self._rows_t))
        return out

    def _new_turn(self) -> None:
        """Restore the snapshot and count the sampled sessions' values
        that differ from it."""
        self._restore()
        c, s, rows = self.cache, self.snap, self._rows_t
        self._restore_bad += (
            (c.state.index_select(1, rows) != s.state.index_select(1, rows))
            .sum() + (c.conv.index_select(1, rows)
                      != s.conv.index_select(1, rows)).sum())

    def unit(self) -> None:
        tf = self.traffic
        if self._turn_step == tf["steps"]:
            self._new_turn()
            self._tok = self._first(5, self.turns)
            self._turn_step, self._turn = 0, None
            self.turns += 1
            if self.kept.wants():
                self._turn = {"steps": []}
                self.kept.put(self._turn)
        pos = tf["context"] + self._turn_step
        if self._turn is not None:
            self._store[0] = {}
        logp = self.step(self._tok, pos)
        self._tok = logp.argmax(-1)
        if self._turn is not None:
            rec = {k: v[0] for k, v in self._store[0].items()}
            rec["logp"], rec["pos"] = logp[self.check], pos
            self._turn["steps"].append(rec)
            self._store[0] = None
            if self._turn_step == tf["steps"] - 1:
                self._turn["end"] = self._kda_now(self.cache.state,
                                                  self.cache.conv)
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
        """Keep the sampled layers' and ``lm_head``'s served weights, the
        sampled sessions' prefilled latent entries and KDA state and
        tails, and the restores' count; print the cache's and the expert
        layers' counts a step."""
        from tq_tpu_torch.layers.moe import moe_apply

        names = [n for i in self.layers for n in ref.layer_shapes(self.cfg, i)
                 if ref.is_linear(n)] + ["lm_head"]
        self.weights = {n: self.qparams[n] for n in names}
        T = self.traffic["context"]
        self.prefill_cache = {
            i: self.cache.latent[self.cache.slots[i]][self.check, :T].clone()
            for i in self.layers if not ref.is_kda(self.cfg, i)}
        self.prefill_state = self._kda_now(self.snap.state, self.snap.conv)
        self.restore_bad = int(self._restore_bad)
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
        print("benchmark: cache.counts: " + json.dumps(self.cache.counts),
              file=sys.stderr)
        del self.qparams, self.cache, self.snap, self.step, self._restore

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

    def _follow(self, w, i: int, turns, control: bool) -> list[dict]:
        """Layer ``i`` over the prefill and each sampled turn."""
        cfg, pre = self.cfg, f"layers.{i}"
        P = self.prefill
        gate = P.get(f"{pre}.mlp.gate")
        if not ref.is_kda(cfg, i):
            out = [ref.follow_mla(w, cfg, i, P.get(f"{pre}.input"),
                                  P.get(f"{pre}.output"),
                                  P.get(f"{pre}.latent"), gate,
                                  control=control)]
            for turn in turns:
                written = []
                for rec in turn["steps"]:
                    x, y = rec.get(f"{pre}.input"), rec.get(f"{pre}.output")
                    entry, sel = (rec.get(f"{pre}.latent"),
                                  rec.get(f"{pre}.mlp.gate"))
                    if x is None or y is None or entry is None:
                        out.append(ref.follow_mla(w, cfg, i, None, None,
                                                  None, None))
                        break
                    prev = torch.cat([self.prefill_cache[i]] + written, 1)
                    out.append(ref.follow_mla(
                        w, cfg, i, x[:, None], y[:, None], entry[:, None],
                        None if sel is None else sel[:, None], prev,
                        rec["pos"], control))
                    written.append(entry[:, None])
            return out
        state, tail = self.prefill_state[i]
        x = P.get(f"{pre}.input")
        out = [ref.follow_kda(w, cfg, i, [x], [P.get(f"{pre}.output")],
                              [gate], torch.zeros_like(state),
                              torch.zeros_like(tail), state, tail, control)]
        for turn in turns:
            steps = turn["steps"]

            def col(key, steps=steps):
                vals = [rec.get(f"{pre}.{key}") for rec in steps]
                return [None if v is None else v[:, None] for v in vals]

            end = turn.get("end", {}).get(i, (None, None))
            out.append(ref.follow_kda(w, cfg, i, col("input"), col("output"),
                                      col("mlp.gate"), state, tail, *end,
                                      control=control))
        return out

    def readings(self, control: bool = False) -> dict:
        """``weight_mismatch``; the most ``layer_gap``, ``state_gap`` and
        ``cache_gap`` and the summed ``route_mismatch`` and
        ``route_near`` of the sampled layers over the prefill and each
        sampled turn's steps (``reference.follow_kda``, ``.follow_mla``);
        ``logit_gap`` of each sampled step (``reference.follow_head``);
        ``restore_mismatch``.  With ``control`` the reference at TF32
        takes the program's place (its weights are the reference's own,
        its restore none)."""
        cfg, dev, seed = self.cfg, self.run.device, self.run.seed
        turns = [t for t in self.kept.items if t and t["steps"]]
        if not turns or not self.prefill:
            return dict.fromkeys(READINGS, float("inf"))
        found = dict.fromkeys(READINGS, 0.0)
        found["restore_mismatch"] = 0 if control else self.restore_bad
        for i in self.layers:
            names = list(ref.layer_shapes(cfg, i))
            w = ref.convert(cfg, seed, names, dev)
            if not control:
                found["weight_mismatch"] += self._mismatch(
                    w, [n for n in names if ref.is_linear(n)])
            for f in self._follow(w, i, turns, control):
                for k in ("layer_gap", "state_gap", "cache_gap"):
                    found[k] = max(found[k], f[k])
                for k in ("route_mismatch", "route_near"):
                    found[k] += f[k]
            del w
        w = ref.convert(cfg, seed, ["norm", "lm_head"], dev)
        if not control:
            found["weight_mismatch"] += self._mismatch(w, ["lm_head"])
        for turn in turns:
            for rec in turn["steps"]:
                found["logit_gap"] = max(found["logit_gap"], ref.follow_head(
                    w, cfg, rec["norm"], rec["logp"], control))
        return found
