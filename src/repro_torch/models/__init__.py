"""The LM stack's serving path: four model families over one API.

:func:`repro_torch.models.api.build_model` returns a
:class:`~repro_torch.models.api.Model` for any
:class:`~repro_torch.config.ArchConfig`: the decoder-only transformer
(:mod:`.transformer`, dense / GQA / SWA / MoE / VLM backbone), Mamba-2
(:mod:`.mamba2`), the RG-LRU hybrid (:mod:`.rglru`) and the Whisper
encoder-decoder (:mod:`.whisper`), on the shared layers of
:mod:`.layers`.  Parameters are nested dicts of tensors under the JAX
package's tree names and shapes (:mod:`.params`); :mod:`.convert`
carries that package's numpy trees across.
"""
from .api import Model, build_model, chunked_ce_loss
from .convert import params_from_numpy
from .params import ParamSpec, count_params, init_params

__all__ = ["Model", "ParamSpec", "build_model", "chunked_ce_loss",
           "count_params", "init_params", "params_from_numpy"]
