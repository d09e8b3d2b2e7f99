"""Shared set-up of the port's parity tests (``test_torch_*.py``): the same
float32 config in both packages, and reference weights carried to the port
through the numpy bridge. float32 because greedy-token identity across two
frameworks needs the arithmetic, not bf16 rounding, to decide the argmax."""

import dataclasses

import jax
import numpy as np

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.transformer import LM as JaxLM
from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config


def configs(arch: str = "edge-tiny", smoke: bool = False):
    """(reference config, port config), both float32."""
    j = (jax_smoke_config if smoke else jax_config)(arch)
    t = (get_smoke_config if smoke else get_config)(arch)
    return (dataclasses.replace(j, dtype="float32"),
            dataclasses.replace(t, dtype="float32"))


def weights(jcfg, tcfg, seed: int = 0):
    """(reference params, the same params as port tensors on the CPU)."""
    jp = JaxLM(jcfg).init(jax.random.key(seed))
    return jp, bridge.params_to_torch(jax.tree.map(np.asarray, jp), tcfg,
                                      "cpu")


def prompt(n: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, size=n).astype(
        np.int32)


def fresh(engine):
    """``engine`` with every slot released, for reuse by the next test."""
    for sid in list(engine._slot_map):
        engine.release_slot(sid)
    return engine


class Bridged:
    """A port engine as the reference package sees it: payloads cross as
    numpy, through the bridge."""

    def __init__(self, engine):
        self.engine = engine

    def __getattr__(self, name):
        return getattr(self.engine, name)

    def export_slot(self, sid):
        return bridge.payload_to_numpy(self.engine.export_slot(sid))
