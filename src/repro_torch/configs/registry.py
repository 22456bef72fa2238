"""``--arch <id>`` registry: maps arch ids to (CONFIG, REDUCED)."""

from __future__ import annotations

import importlib
from typing import Any, Tuple

_ARCH_MODULES = {
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "bert4rec": "repro_torch.configs.bert4rec",
    "wide-deep": "repro_torch.configs.wide_deep",
    "mind": "repro_torch.configs.mind",
    "dlrm-rm2": "repro_torch.configs.dlrm_rm2",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> Any:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.REDUCED if reduced else mod.CONFIG


def get_both(arch_id: str) -> Tuple[Any, Any]:
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.CONFIG, mod.REDUCED
