"""repro_torch.models — the PyTorch port of ``repro.models``, the model zoo.

The forward path of the ten assigned archs (dense, MoE and VLM
transformers, the Mamba2 stack, the jamba hybrid and the whisper
encoder-decoder) behind :func:`build`'s :class:`ModelApi`, with the
configs (:func:`get_config`, :func:`list_archs`) and the layers they
share; each family's decode path (``init_cache``, ``prefill``,
``decode_step``), which the serve engine drives; and the backward that
``repro_torch.train`` takes through ``api.loss``, under the config's
``remat``.
"""
from . import layers
from .api import ModelApi, build, family_module
from .config import ModelConfig, get_config, list_archs, register_arch

__all__ = ["ModelApi", "ModelConfig", "build", "family_module",
           "get_config", "layers", "list_archs", "register_arch"]
