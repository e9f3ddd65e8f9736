import subprocess
from datetime import datetime
from pathlib import Path

from setuptools import find_packages, setup


def _write_version():
    """Stamp version.py from the git commit time (≡ the reference's scheme,
    ``setup.py:12-24``)."""
    try:
        commit = subprocess.check_output(
            ["git", "rev-parse", "HEAD"], stderr=subprocess.DEVNULL
        ).decode().strip()
        ts = int(
            subprocess.check_output(
                ["git", "log", "-1", "--format=%ct"], stderr=subprocess.DEVNULL
            ).decode().strip()
        )
        stamp = datetime.utcfromtimestamp(ts).strftime("%Y.%m.%d")
        content = (
            '"""Generated by setup.py."""\n\n'
            f'__version__ = "0.1.0+{stamp}"\n__commit__ = "{commit}"\n'
        )
        for package in ("tts_with_diffusion_model_tpu", "tts_with_diffusion_model_tpu_torch"):
            (Path(__file__).parent / package / "version.py").write_text(content)
    except Exception:
        pass


_write_version()

setup(
    name="tts-with-diffusion-model-tpu",
    python_requires=">=3.10.0",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA/Pallas/pjit) zero-shot voice-cloning TTS over "
        "discrete EnCodec codec tokens with AR, NAR, and D3PM discrete-"
        "diffusion model families"
    ),
    long_description=(Path(__file__).parent / "README.md").read_text(),
    long_description_content_type="text/markdown",
    packages=find_packages(exclude=["tests*"]),
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "scipy",
        "pyyaml",
    ],
)
