"""Compare generated results files against the published ones.

Port of ``tq_tpu.evals.compare``::

    python -m tq_tpu_torch.evals.compare [ours_dir] [reference_dir]

``reference_dir`` defaults to this repository's ``results/``, which holds
the published files.  The deterministic columns (tmacs, avg_terms, params,
param_bits at g=1) must match after the float32 cast of the reference's
hook buffers; data-dependent columns (accs, ppls, compressed-HESE
param_bits) are reported, comparable only with the real datasets and
checkpoints.  Every column of every published file is MATCH, MATCH after
a documented exact offset, an annotated documented divergence, or
data-dependent.  Exits 1 if any deterministic column mismatches or a
published file was not generated.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

__all__ = ["compare_file", "main", "COLUMN_NOTES", "REFERENCE_DIR"]

REFERENCE_DIR = Path(__file__).resolve().parents[2] / "results"


def _f32(xs):
    return [float(np.float32(v)) for v in xs]


def _cmp_seq(name, ours, ref, exact=True, note=None):
    n = min(len(ours), len(ref))
    if len(ours) != len(ref):
        return (f"  {name}: LENGTH mismatch (ours {len(ours)} vs "
                f"published {len(ref)})")
    if n == 0:
        return f"  {name}: (no overlap)"
    a, b = _f32(ours[:n]), _f32(ref[:n])
    if a == b:
        tag = "MATCH" if note is None else f"MATCH ({note})"
        return f"  {name}: {tag} ({n} values)"
    rel = max(abs(x - y) / max(abs(y), 1e-12) for x, y in zip(a, b))
    if rel < 1e-6:
        return f"  {name}: MATCH(f32-ulp) max rel {rel:.2e} ({n} values)"
    if note is not None:
        return (f"  {name}: differs (documented: {note}) "
                f"max rel {rel:.2e} ({n} values)")
    tag = "MISMATCH" if exact else "differs (data-dependent)"
    return f"  {name}: {tag} max rel {rel:.2e} ({n} values)"


# The published mobilenet_v2 TR rows come from an older counter revision
# that also billed the 17 depthwise convs (20,716,416 MACs in all) at the
# exempt layers' 16 terms; the counter here excludes grouped convs.  Adding
# dt * 16 * 20,716,416 to our tmacs reproduces the published column bit
# for bit.
_MOBILENET_DW_MACS = 20_716_416

# Annotated data-independent divergences that survive all corrections.
COLUMN_NOTES = {
    ("efficientnet_b0-results.json", "params"):
        "published file says 9,253,216; the real efficientnet-b0 "
        "parameter count is 5,288,548 (torch & ours agree) — "
        "unexplained upstream value, see PARITY.md",
    ("mnist-tr.json", "param_bits"):
        "counted with the reference's merging-neighbors hese() "
        "(tr_layer.py:32-39, modeled exactly); residual gap is "
        "checkpoint-dependent (published run's trained weights)",
    ("lstm-tr.json", "param_bits"):
        "counted with the reference's merging-neighbors hese() "
        "(tr_layer.py:32-39, modeled exactly); residual gap is "
        "checkpoint-dependent (published run's trained weights)",
}


def _tmacs_offset(fname: str, key: str) -> int:
    """The exact correction added to our tmacs of one row before
    comparing."""
    if fname == "mobilenet_v2-results.json" and key.startswith("tr-data"):
        return int(key[len("tr-data"):]) * 16 * _MOBILENET_DW_MACS
    return 0


def compare_file(ours_path: Path, ref_path: Path) -> list[str]:
    """One line per column of the published file ``ref_path``, headed by
    the file's name."""
    ours = json.loads(Path(ours_path).read_text())
    ref = json.loads(Path(ref_path).read_text())
    fname = Path(ours_path).name
    out = [f"{fname}:"]
    if "tmacs" in ours:  # the MLP / LSTM flat schema
        out.append(_cmp_seq("tmacs", ours["tmacs"], ref["tmacs"]))
        metric = "ppls" if "ppls" in ours else "accs"
        out.append(_cmp_seq(metric, ours[metric], ref[metric], exact=False))
        out.append(_cmp_seq("param_bits", ours["param_bits"],
                            ref["param_bits"], exact=False,
                            note=COLUMN_NOTES.get((fname, "param_bits"))))
        return out
    for key in ref:  # the CNN / group-size nested schema
        if key not in ours:
            out.append(f"  {key}: missing")
            continue
        if "tmacs" in ref[key]:
            off = _tmacs_offset(fname, key)
            note = (f"after documented +dt*16*{_MOBILENET_DW_MACS:,} "
                    "depthwise offset" if off else None)
            out.append(_cmp_seq(f"{key}.tmacs",
                                [v + off for v in ours[key]["tmacs"]],
                                ref[key]["tmacs"], note=note))
        if "avg_terms" in ref[key]:
            out.append(_cmp_seq(f"{key}.avg_terms", ours[key]["avg_terms"],
                                ref[key]["avg_terms"]))
        if "params" in ref[key] and "params" in ours[key]:
            out.append(_cmp_seq(f"{key}.params", ours[key]["params"],
                                ref[key]["params"],
                                note=COLUMN_NOTES.get((fname, "params"))))
        if "accs" in ref[key]:
            out.append(_cmp_seq(f"{key}.accs", ours[key]["accs"],
                                ref[key]["accs"], exact=False))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="compare results files against the published ones")
    ap.add_argument("ours", nargs="?", default="results")
    ap.add_argument("reference", nargs="?", default=str(REFERENCE_DIR))
    a = ap.parse_args(argv)
    ours_dir, ref_dir = Path(a.ours), Path(a.reference)
    if not ref_dir.is_dir():
        print(f"reference results not found at {ref_dir}")
        return 0
    bad = 0
    for ref_path in sorted(ref_dir.glob("*.json")):
        ours_path = ours_dir / ref_path.name
        if not ours_path.exists():
            print(f"{ref_path.name}: not generated here")
            bad += 1
            continue
        lines = compare_file(ours_path, ref_path)
        bad += sum("MISMATCH" in ln or "LENGTH" in ln for ln in lines)
        print("\n".join(lines))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
