"""The evaluation entry points (counterparts of the JAX repository's
``scripts/{heldout_eval,speaker_transfer_eval,quality_gate,
longform_seam_eval}.py``), run as
``python -m tts_with_diffusion_model_tpu_torch.scripts.<name>``.

Each keeps its counterpart's arguments, defaults and JSON keys, and is split
into *select* (numpy ``default_rng(seed)`` picks, prompts and input arrays),
*generate* (the port's models on the card) and *score*
(``utils/metrics``).  The first stage draws its noise from ``RowKeys``, so a
sampled output matches the JAX package's only under injected noise or at
temperature 0.
"""
