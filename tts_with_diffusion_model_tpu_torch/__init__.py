"""PyTorch/CUDA port of the D3PM codec-token TTS system.

The JAX package ``tts_with_diffusion_model_tpu`` beside this one is the
reference; this package mirrors its module paths and never imports it (nor
``jax`` / ``flax``).  Entry points run on the card (``device="cuda"``) unless
the caller asks for the CPU.
"""

__version__ = "0.1.0"
