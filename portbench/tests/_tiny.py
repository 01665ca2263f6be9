"""Tiny configurations and mixes for the CPU tests of the benchmark."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

DENSE = dict(name="tiny-dense", model_type="qwen3", hidden_size=64,
             intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, head_dim=16,
             vocab_size=1000, rope_theta=10000, rms_norm_eps=1e-6,
             hidden_act="silu", tie_word_embeddings=True)
MOE = dict(DENSE, name="tiny-moe", model_type="granitemoe", head_dim=None,
           num_local_experts=8, num_experts_per_tok=2, capacity_factor=1.25)
PREFILL = dict(kind="prefill", batch=4, prompt_tokens=64, sessions=12,
               check={"rows": 2, "within": 3})
# the metrics a tiny cell reports
END_TO_END = [
    {"name": "prefill_tokens_per_s", "unit": "tokens/s"},
    {"name": "setup_s", "unit": "s"}]
PER_LAYER = [
    {"name": n, "unit": u} for n, u in (
        ("host_issue_ms.prefill", "ms"), ("mfu_pct.prefill", "%"),
        ("flash_attention_roofline", "%"),
        ("device_idle_pct.prefill", "%"))]
# the tiny cells' limits: above what the sound bf16 program reads on the
# CPU (a mean gap under 0.03, a cache gap of 0.01 dense and up to 0.17 MoE,
# where a flipped expert moves a token's later keys; a flip moves the
# widest token gap past 1), far below what each planted fault reads (a
# mean gap over 1.4, a cache gap of 1 or more)
LIMITS = {"mean_gap": 0.1, "kv_gap": 0.4}
