"""The port's preprocessing CLIs against the JAX package's, on the CPU:
``emb.g2p`` writes the same ``.phn.txt`` files and skips existing ones;
``emb.qnt`` writes ``.qnt.npy`` arrays identical to the JAX CLI's (int16,
``(8, frames)``) from the same seeded codec weights, given through
``$ENCODEC_WEIGHTS``, for short seeded wavs, one of them stereo."""

import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from tts_with_diffusion_model_tpu.codec import encodec as jax_encodec
from tts_with_diffusion_model_tpu.codec.convert import save_npz_params
from tts_with_diffusion_model_tpu.emb import g2p as jax_g2p
from tts_with_diffusion_model_tpu.emb import qnt as jax_qnt
from tts_with_diffusion_model_tpu_torch.audio.wavio import write_wav
from tts_with_diffusion_model_tpu_torch.codec.encodec import find_weights, load_codec
from tts_with_diffusion_model_tpu_torch.emb import g2p, qnt

from torch_port_helpers import one_thread  # noqa: F401 (fixture)

#: a few short wavs: one intra-op thread each
pytestmark = pytest.mark.usefixtures("one_thread")

TEXTS = ("The quick brown fox jumps over the lazy dog.",
         "She said: we would go there in the morning, 42 times!",
         "How are you doing today, my friend?")


def _run_jax(monkeypatch, main, *argv):
    monkeypatch.setattr(sys, "argv", ["prog", *map(str, argv)])
    main()


def _text_folder(root: Path) -> Path:
    for i, text in enumerate(TEXTS):
        d = root / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        (d / f"utt{i}.normalized.txt").write_text(text, encoding="utf8")
    return root


def test_g2p_cli_writes_the_jax_phones_and_skips_existing(tmp_path, monkeypatch):
    mine, ref = _text_folder(tmp_path / "port"), _text_folder(tmp_path / "jax")
    written = g2p.main([str(mine)])
    _run_jax(monkeypatch, jax_g2p.main, ref)
    assert len(written) == len(TEXTS)
    for path in sorted(ref.rglob("*.phn.txt")):
        got = (mine / path.relative_to(ref)).read_text()
        assert got == path.read_text() and len(got.split()) > 5, path.name
    assert g2p.encode(TEXTS[0]) == jax_g2p.encode(TEXTS[0])  # the re-export
    # an existing output is left alone
    first = sorted(mine.rglob("*.phn.txt"))[0]
    first.write_text("kept")
    assert g2p.main([str(mine)]) == []
    assert first.read_text() == "kept"


@pytest.fixture
def seeded_codec(tmp_path, monkeypatch):
    """The JAX codec's seeded init saved as converted weights, and
    ``$ENCODEC_WEIGHTS`` pointing at them (the JAX CLI's singleton dropped
    before and after)."""
    params = jax_encodec.Codec(None, rng_seed=3).params
    path = tmp_path / "codec.npz"
    save_npz_params(jax.tree.map(np.asarray, params), path)
    monkeypatch.setenv("ENCODEC_WEIGHTS", str(path))
    jax_qnt.unload_codec()
    yield path
    jax_qnt.unload_codec()


def _wav_folder(root: Path) -> Path:
    rs = np.random.RandomState(0)
    for i, (seconds, channels) in enumerate(((0.3, 1), (0.45, 2), (0.25, 1))):
        n = int(seconds * 24000)
        tt = np.arange(n) / 24000
        wav = 0.3 * np.sin(2 * np.pi * rs.uniform(100, 300) * tt) + 0.05 * rs.randn(n)
        wav = np.stack([wav, 0.5 * rs.randn(n)]) if channels == 2 else wav[None]
        d = root / f"spk{i}"
        d.mkdir(parents=True)
        write_wav(d / f"utt{i}.wav", np.clip(wav, -1, 1).astype(np.float32), 24000)
    return root


def test_qnt_cli_writes_the_jax_codes(tmp_path, monkeypatch, seeded_codec):
    assert find_weights() == seeded_codec
    mine = _wav_folder(tmp_path / "port")
    ref = tmp_path / "jax"
    shutil.copytree(mine, ref)
    written = qnt.main([str(mine), "--device", "cpu"])
    _run_jax(monkeypatch, jax_qnt.main, ref)
    assert len(written) == 3
    for path in sorted(ref.rglob("*.qnt.npy")):
        got, want = np.load(mine / path.relative_to(ref)), np.load(path)
        assert got.dtype == want.dtype == np.int16 and got.shape[0] == 8 and got.shape[1] > 0
        np.testing.assert_array_equal(got, want, err_msg=path.name)
    # the stereo file is encoded from its first channel
    codec = load_codec(seeded_codec, device="cpu")
    stereo = mine / "spk1" / "utt1.wav"
    np.testing.assert_array_equal(qnt.encode_from_file(stereo, codec),
                                  np.load(mine / "spk1" / "utt1.qnt.npy"))
    assert qnt.main([str(mine), "--device", "cpu"]) == []  # existing outputs skipped


def test_qnt_codec_weights_resolve_in_the_jax_order(tmp_path, monkeypatch, seeded_codec):
    explicit = tmp_path / "other.npz"
    shutil.copy(seeded_codec, explicit)
    assert find_weights(explicit) == explicit
    assert find_weights() == seeded_codec  # $ENCODEC_WEIGHTS before zoo/
    with pytest.raises(FileNotFoundError):
        find_weights(tmp_path / "missing.npz")
    monkeypatch.delenv("ENCODEC_WEIGHTS")
    monkeypatch.chdir(tmp_path)
    zoo = Path(qnt.__file__).resolve().parents[2] / "zoo" / "encodec_24khz.npz"
    assert find_weights() == (zoo if zoo.exists() else None)
    (tmp_path / "zoo").mkdir()
    shutil.copy(seeded_codec, tmp_path / "zoo" / "encodec_24khz.npz")
    assert find_weights() == Path("zoo/encodec_24khz.npz")


def test_qnt_decode_to_file_round_trip(tmp_path, seeded_codec):
    from tts_with_diffusion_model_tpu_torch.audio.wavio import read_wav

    codec = load_codec(seeded_codec, device="cpu")
    codes = qnt.encode_from_file(_wav_folder(tmp_path / "w") / "spk0" / "utt0.wav", codec)
    qnt.decode_to_file(codes.T, tmp_path / "out.wav", codec)
    wav, sr = read_wav(tmp_path / "out.wav")
    assert sr == 24000 and wav.shape == (1, codes.shape[1] * 320) and np.isfinite(wav).all()
    with pytest.raises(ValueError, match="shape"):
        qnt.decode_to_file(codes[None], tmp_path / "bad.wav", codec)
