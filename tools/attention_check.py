#!/usr/bin/env python3
"""Readings of `chip_smoke.py`'s bf16 attention check over several seeds,
on the card: what its limit `ATTN_BF16_ROW_TOL` was set from.

For each seed and each bf16 shape that `chip_smoke.py` checks (the CPU
tests' sweep, causal and full, the ragged s = 200, Sk = 256 != S = 128,
the two batches of two with a ragged tail (`chip_smoke.ATTN_BATCH_EDGES`),
every compiled head dim with blocks of 64, and one causal 32k prefill at
Qwen2.5-32B's widths), it prints `chip_smoke.attention_row_err` against
`flash_attention_plain` for
  - `row_err`: the kernel;
  - `plain_bf16_p`: the plain version with P rounded to bf16, as the kernel
    rounds it (a sound reading that needs no card kernel);
  - `control`: the plain version with P rounded to e4m3
    (`chip_smoke.ATTN_CONTROL`), which the limit must reject;
and `abs_err`, the kernel's max|kernel - plain|.  The last line is a JSON
summary: the largest sound reading and the smallest control reading.

    python3 tools/attention_check.py [--seeds 4]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("attention_check: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    print(json.dumps({"card": cs.card_line()}), flush=True)
    cases = [(shape, None, causal, {}) for causal in (True, False) for shape in cs.ATTN_SWEEP]
    cases += [((1, 200, 4, 2, 32), None, causal, {}) for causal in (True, False)]
    cases += [((1, 128, 4, 2, 64), 256, causal, {}) for causal in (True, False)]
    cases += [(shape, sk, causal, {}) for causal in (True, False) for shape, sk in cs.ATTN_BATCH_EDGES]
    cases += [((1, cs.ATTN_HEAD_DIM_S, 8, 2, d), None, True, {"bq": 64, "bk": 64}) for d in fa.HEAD_DIMS]
    cases += [(cs.ATTN_FULL, None, True, {})]
    rows = []
    for seed in range(args.seeds):
        rng = np.random.default_rng(seed)
        for (b, s, h, kv, d), sk, causal, blocks in cases:
            sk = s if sk is None else sk
            q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).cuda().bfloat16()
                       for shape in ((b, s, h, d), (b, sk, kv, d), (b, sk, kv, d)))
            want = fa.flash_attention_plain(q, k, v, causal=causal, **blocks)
            got = fa.flash_attention(q, k, v, causal=causal, **blocks)
            row = {
                "seed": seed, "B,S,Sk,H,KV,D": [b, s, sk, h, kv, d], "causal": causal,
                "row_err": cs.attention_row_err(got, want),
                "plain_bf16_p": cs.attention_row_err(
                    fa.flash_attention_plain(q, k, v, causal=causal, p_dtype=torch.bfloat16, **blocks), want),
                "control": cs.attention_row_err(
                    fa.flash_attention_plain(q, k, v, causal=causal, p_dtype=cs.ATTN_CONTROL, **blocks), want),
                "abs_err": float((got.float() - want.float()).abs().max()),
            }
            print(json.dumps(row), flush=True)
            rows.append(row)
            del q, k, v, want, got
            torch.cuda.empty_cache()
    print(json.dumps({
        "limit": cs.ATTN_BF16_ROW_TOL,
        "max_row_err": max(r["row_err"] for r in rows),
        "max_plain_bf16_p": max(r["plain_bf16_p"] for r in rows),
        "min_control": min(r["control"] for r in rows),
        "max_abs_err": max(r["abs_err"] for r in rows),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
