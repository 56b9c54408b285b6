"""YAML configuration with ``${env:VAR,default}`` resolution.

The reference uses OmegaConf with a registered ``env`` resolver and a
``config.yaml`` that is referenced everywhere but never committed
(reference/ASV_func.py:14-19; SURVEY.md preamble). The schema below is the
one reverse-engineered from usage: ``paths.{metadata_path, flac_folder,
in_the_wild_dir}`` and per-dataset blocks
``datasets.{DF,PA,LA}.{metadata, flac, columns}``.

OmegaConf is not installed; this is a small self-contained equivalent on
pyyaml with dotted access and the same interpolation syntax. A copy of the
JAX package's ``io/config.py`` (importing that package imports jax), with
``import yaml`` inside the two loaders: the port imports on machines
without pyyaml, and only loading a config needs it.
"""

from __future__ import annotations

import os
import re
from typing import Any

_ENV_RE = re.compile(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)(?:,([^}]*))?\}")


class ConfigNode(dict):
    """dict with attribute access and recursive wrapping."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value


def _resolve(value: Any) -> Any:
    if isinstance(value, str):
        def sub(m: re.Match) -> str:
            var, default = m.group(1), m.group(2)
            if var in os.environ:
                return os.environ[var]
            if default is not None:
                return default
            raise KeyError(f"environment variable {var!r} not set and no default given")

        return _ENV_RE.sub(sub, value)
    if isinstance(value, dict):
        return ConfigNode({k: _resolve(v) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve(v) for v in value]
    return value


def load_config(path: str) -> ConfigNode:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    return _resolve(raw)


def loads_config(text: str) -> ConfigNode:
    import yaml

    return _resolve(yaml.safe_load(text) or {})


DEFAULT_CONFIG_TEMPLATE = """\
# Schema matching the reference's (uncommitted) config.yaml usage.
paths:
  metadata_path: ${env:ASV_METADATA,./data/metadata}
  flac_folder: ${env:ASV_FLAC,./data/flac}
  in_the_wild_dir: ${env:ASV_ITW,./data/in_the_wild}
datasets:
  # column lists as printed by the reference notebooks
  # (ASV_deep_learning.ipynb cell 2, ASV_dataset.ipynb cell 3); schema
  # auto-detection keys on the column COUNT (reference/ASV_dl_func.py:150-162)
  LA:
    metadata: ${env:ASV_LA_METADATA,./data/LA/metadata.txt}
    flac: [./data/LA/flac]
    columns: [speaker_id, file_id, codec, corpus, attack_id, label, trim, set]
  PA:
    metadata: ${env:ASV_PA_METADATA,./data/PA/metadata.txt}
    flac: [./data/PA/flac]
    columns: [speaker_id, file_id, replay_device, mic, scene, record_id,
              mic_model, scene_setup, channel_config, label, trim, set]
  DF:
    metadata: ${env:ASV_DF_METADATA,./data/DF/metadata.txt}
    flac: [./data/DF/flac]
    columns: [speaker_id, file_id, codec, corpus, attack_id, label, trim,
              set, vocoder, extra]
"""

DEFAULT_COLUMNS = {
    "LA": ["speaker_id", "file_id", "codec", "corpus", "attack_id", "label", "trim", "set"],
    "PA": [
        "speaker_id", "file_id", "replay_device", "mic", "scene", "record_id",
        "mic_model", "scene_setup", "channel_config", "label", "trim", "set",
    ],
    "DF": [
        "speaker_id", "file_id", "codec", "corpus", "attack_id", "label", "trim",
        "set", "vocoder", "extra",
    ],
}
