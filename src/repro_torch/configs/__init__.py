"""Assigned architecture configs — one module per arch (import registers).

Every config carries the exact figures from the assignment brief; deviations
forced by implementation realities are commented inline and summarized in
DESIGN.md §Arch-applicability.
"""
from . import (deepseek_moe_16b, internlm2_1_8b, jamba_v0_1_52b,
               llama3_2_1b, mamba2_780m, moonshot_v1_16b_a3b, qwen2_vl_2b,
               qwen3_1_7b, stablelm_12b, whisper_small)

__all__ = ["deepseek_moe_16b", "internlm2_1_8b", "jamba_v0_1_52b",
           "llama3_2_1b", "mamba2_780m", "moonshot_v1_16b_a3b",
           "qwen2_vl_2b", "qwen3_1_7b", "stablelm_12b", "whisper_small"]
