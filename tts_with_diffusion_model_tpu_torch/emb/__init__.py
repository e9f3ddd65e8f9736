"""Preprocessing CLIs that turn a corpus of wavs and texts into the files
the training loaders read (counterpart of ``emb/`` in the JAX package):
``g2p`` (``*.normalized.txt`` → ``.phn.txt``) and ``qnt`` (``*.wav`` →
``.qnt.npy`` EnCodec codes)."""
