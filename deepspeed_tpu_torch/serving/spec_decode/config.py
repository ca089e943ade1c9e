"""The ``spec_decode`` config block for the serving engine (the port's copy
of ``deepspeed_tpu/serving/spec_decode/config.py``).

Accepted anywhere the serving engine is built::

    init_serving(model, ..., spec_decode={"drafter": "ngram", "k": 4})

``drafter`` selects the proposal source: ``"ngram"`` (prompt lookup: no
second model, proposes by suffix-matching the slot's own history; the right
default for repetitive or extractive traffic), ``"model"`` (a second,
smaller ``InferenceEngine`` passed as ``draft_engine``), or a ready
:class:`~.drafter.Drafter` instance.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class SpecDecodeConfig:
    """Server-global speculative-decoding knobs.

    ``k`` is the draft length: every decode step verifies exactly ``k``
    draft positions (+1 for the current token) in one fixed-shape forward,
    so a larger ``k`` trades verify width for more tokens per accepted
    step. The verify chunk writes ``k+1`` positions past a slot's length
    before rollback, so admission reserves ``k`` positions of headroom:
    ``prompt + max_new_tokens <= capacity - k``.
    """

    enabled: bool = True
    drafter: Any = "ngram"      # "ngram" | "model" | Drafter instance
    k: int = 4                  # draft tokens proposed/verified per step
    max_ngram: int = 3          # n-gram drafter: longest suffix to match
    min_ngram: int = 1          # n-gram drafter: shortest suffix to match
    draft_engine: Any = None    # InferenceEngine for drafter="model"

    @classmethod
    def from_value(cls, value):
        """Coerce the ``spec_decode=`` argument: ``None``/``False`` ->
        ``None`` (speculation off), ``True`` -> defaults, dict -> kwargs,
        instance -> itself."""
        if value is None or value is False:
            return None
        if isinstance(value, cls):
            return value
        if value is True:
            return cls()
        if isinstance(value, dict):
            return cls(**value)
        raise TypeError(f"spec_decode must be a dict, SpecDecodeConfig, "
                        f"bool or None; got {type(value).__name__}")

    def validate(self, capacity: int) -> None:
        if self.k < 1:
            raise ValueError(f"spec_decode.k must be >= 1, got {self.k}")
        if self.k + 1 >= capacity:
            raise ValueError(
                f"spec_decode.k({self.k}) + 1 must be < the KV capacity "
                f"({capacity}); the verify chunk writes k+1 positions")
        if not (1 <= self.min_ngram <= self.max_ngram):
            raise ValueError(
                f"need 1 <= min_ngram({self.min_ngram}) <= "
                f"max_ngram({self.max_ngram})")


def make_drafter(cfg: SpecDecodeConfig):
    """Resolve the config's ``drafter`` selector into a Drafter."""
    from .drafter import Drafter, NGramDrafter, SmallModelDrafter

    if isinstance(cfg.drafter, Drafter):
        return cfg.drafter
    if cfg.drafter == "ngram":
        return NGramDrafter(max_ngram=cfg.max_ngram, min_ngram=cfg.min_ngram)
    if cfg.drafter == "model":
        if cfg.draft_engine is None:
            raise ValueError("spec_decode drafter='model' requires "
                             "draft_engine= (a second InferenceEngine "
                             "sharing the tokenizer)")
        return SmallModelDrafter(cfg.draft_engine)
    raise ValueError(f"unknown drafter {cfg.drafter!r}; expected 'ngram', "
                     f"'model' or a Drafter instance")
