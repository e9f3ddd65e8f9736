"""Generic config machinery: dataclass defaults < YAML < ``key=value`` argv.

Copy of ``utils/config_base.py`` in the JAX package (which rebuilds the
reference's generic trainer config, ``vall_e/utils/config.py:12-121``): the
same three-tier merge precedence, the same ``yaml=<path>`` / bare
``key=value`` CLI convention, ``help=1`` JSON dump, run identity
(``cfg_name``) derived from the YAML path, git state capture, and
``dump()`` writing ``log_dir/cfg.json``.  One difference: ``device``
defaults to ``"cuda"``, because the port's entry points run on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from dataclasses import dataclass, fields
from pathlib import Path
from typing import Any

import yaml


def _coerce(value: str, target_type: Any):
    """Coerce a CLI string to the declared dataclass field type."""
    if value in ("null", "None", "~"):
        return None
    if target_type in (None, Any):
        return yaml.safe_load(value)
    import types
    import typing

    origin = typing.get_origin(target_type)
    args = typing.get_args(target_type)
    # Optional[X] / X | None unions: try the non-None members in order.
    if origin in (typing.Union, types.UnionType):
        if value in ("null", "None", "~"):
            return None
        for a in args:
            if a is type(None):
                continue
            try:
                return _coerce(value, a)
            except (ValueError, TypeError):
                continue
        return yaml.safe_load(value)
    if target_type is bool or target_type == "bool":
        return str(value).lower() in ("1", "true", "yes", "on")
    if target_type is int:
        return int(value)
    if target_type is float:
        return float(value)
    if target_type is Path:
        return Path(value)
    if target_type is str:
        return str(value)
    # lists / everything else: let YAML parse it.
    parsed = yaml.safe_load(value)
    if origin in (list, tuple) and isinstance(parsed, (list, tuple)):
        return list(parsed)
    return parsed


def _is_cfg_argv(s: str) -> bool:
    return "=" in s and "--" not in s


@dataclass(frozen=True)
class ConfigBase:
    """Counterpart of the reference's generic ``Config``.

    Field names deliberately match the reference so existing YAML configs work
    unmodified (``max_iter``, ``eval_every``, ``save_ckpt_every``,
    ``max_train_diffusion_steps``, ``save_on_oom``, ``save_on_quit``, ...).
    """

    cfg_name: str = "my-cfg"
    log_root: Path = Path("logs")
    ckpt_root: Path = Path("ckpts")

    # the torch device the entry points run on: "cuda" (the card) unless
    # the caller asks for "cpu"
    device: str = "cuda"

    max_iter: int = 100_000
    max_grad_norm: float | None = None

    eval_every: int = 1_000
    save_artifacts_every: int | None = 100
    save_ckpt_every: int | None = None
    max_train_diffusion_steps: int | None = None
    save_on_oom: bool = True
    save_on_quit: bool = True
    seed: int = 0

    @property
    def relpath(self) -> Path:
        return Path(self.cfg_name)

    @property
    def ckpt_dir(self) -> Path:
        return Path(self.ckpt_root) / self.relpath

    @property
    def log_dir(self) -> Path:
        return Path(self.log_root) / self.relpath / str(self.start_time)

    # cached start time without cached_property (frozen dataclass friendly)
    @property
    def start_time(self) -> int:
        if "_start_time" not in self.__dict__:
            object.__setattr__(self, "_start_time", int(time.time()))
        return self.__dict__["_start_time"]

    @property
    def git_commit(self) -> str:
        try:
            return (
                subprocess.check_output(
                    "git rev-parse HEAD".split(), stderr=subprocess.DEVNULL
                )
                .decode("utf8")
                .strip()
            )
        except Exception:
            return ""

    @property
    def git_status(self) -> str:
        try:
            return (
                subprocess.check_output(
                    "git status".split(), stderr=subprocess.DEVNULL
                )
                .decode("utf8")
                .strip()
            )
        except Exception:
            return ""

    def dumps(self) -> str:
        data = {}
        for k in dir(self):
            if k.startswith("_"):
                continue
            try:
                v = getattr(self, k)
            except Exception:
                continue
            if callable(v):
                continue
            data[k] = v
        return json.dumps(data, indent=2, default=str)

    def dump(self, path: Path | None = None):
        if path is None:
            path = self.log_dir / "cfg.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.dumps())

    @classmethod
    def from_cli(cls, argv: list[str] | None = None):
        """Build a config from ``defaults < yaml=<path> < key=value`` argv.

        Mirrors the reference CLI contract (``utils/config.py:82-106``):
        ``--``-prefixed args are left in ``sys.argv`` for argparse consumers;
        ``help=1`` prints the defaults as JSON and exits.
        """
        own_argv = argv is not None
        if argv is None:
            argv = sys.argv
        cli_pairs = [s for s in argv if _is_cfg_argv(s)]
        if not own_argv:
            sys.argv = [s for s in argv if not _is_cfg_argv(s)]

        cli_cfg: dict[str, str] = {}
        for s in cli_pairs:
            k, _, v = s.partition("=")
            cli_cfg[k.strip()] = v

        if cli_cfg.get("help"):
            print("Configurable hyperparameters with their default values:")
            print(json.dumps(dataclasses.asdict(cls()), indent=2, default=str))
            sys.exit(0)

        yaml_cfg: dict[str, Any] = {}
        if "yaml" in cli_cfg:
            yaml_path = Path(cli_cfg.pop("yaml"))
            with open(yaml_path) as f:
                yaml_cfg = yaml.safe_load(f) or {}
            # Run identity derives from the YAML's path with its first
            # component (the config root dir) and suffix stripped, matching
            # the reference's cfg_name scheme.
            try:
                rel = yaml_path.absolute().relative_to(Path.cwd())
                parts = rel.parts[1:] if len(rel.parts) > 1 else rel.parts
            except ValueError:
                parts = yaml_path.parts[-2:]
            yaml_cfg.setdefault("cfg_name", str(Path(*parts).with_suffix("")))

        import typing

        try:
            field_types = typing.get_type_hints(cls)
        except Exception:
            field_types = {f.name: f.type for f in fields(cls)}
        merged: dict[str, Any] = {}
        for k, v in yaml_cfg.items():
            if k in field_types:
                t = field_types[k]
                if t is Path and v is not None:
                    v = Path(v)
                if "Path]" in str(t) and isinstance(v, (list, tuple)):
                    v = [Path(x) for x in v]
                merged[k] = v
        for k, v in cli_cfg.items():
            if k in field_types:
                merged[k] = _coerce(v, field_types[k])

        return cls(**merged)

    def __repr__(self):
        return self.dumps()
