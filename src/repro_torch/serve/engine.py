"""Batched LM serving engine: prefill + greedy/temperature decode loop.

One engine per (model, params).  Requests are token prompts of equal
padded length; the engine runs them in one prefill call (the first new
token comes from its logits), then exactly ``max_new_tokens - 1`` decode
steps with the per-family cache (KV ring / SSM state / RG-LRU state),
each a plain eager call of ``model.decode_step``.  Nothing leaves the
device inside the loop: sampling and the EOS bookkeeping are tensor ops.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import check_on_device, resolve_device
from ..models.params import tree_leaves

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_id: int | None = None


class Engine:
    """``model`` has the :class:`~repro_torch.models.api.Model` serving
    surface (``prefill``, ``decode_step``); ``params`` lie on ``device``
    (default the card; it raises without one)."""

    def __init__(self, model, params, cfg: ServeConfig = ServeConfig(),
                 device="cuda"):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is not None:
            check_on_device("Engine params", self.device,
                            *tree_leaves(params))

    def _sample(self, logits, gen):
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    @torch.inference_mode()
    def generate(self, batch: dict, seed: int | None = None) -> torch.Tensor:
        """batch: a prompt batch (``Model.input_specs`` of kind
        ``prefill``) on the engine's device.  Returns the generated tokens
        (B, max_new_tokens), int64.  Temperature sampling draws from a
        generator on the device seeded with ``seed`` (None: 0, as the JAX
        package's ``key=None`` is ``PRNGKey(0)``)."""
        check_on_device("Engine.generate batch", self.device,
                        *batch.values())
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0 if seed is None else seed)
        prompt_len = batch["tokens"].shape[1]
        patches = batch.get("patches")
        extra = patches.shape[1] if patches is not None else 0
        logits, caches = self.model.prefill(
            self.params, batch,
            cache_len=prompt_len + extra + self.cfg.max_new_tokens)
        tok = self._sample(logits, gen)
        eos = self.cfg.eos_id
        # a sequence whose first token is EOS is finished: it emits EOS on
        done = (tok == eos) if eos is not None else None
        out = [tok]
        for _ in range(self.cfg.max_new_tokens - 1):
            logits, caches = self.model.decode_step(self.params, caches,
                                                    tok[:, None])
            tok = self._sample(logits, gen)
            if eos is not None:
                done = done | (tok == eos)
                tok = torch.where(done, eos, tok)
            out.append(tok)
        return torch.stack(out, dim=1)
