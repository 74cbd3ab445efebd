"""Hugging Face Hub access to pre-trained models (port of
flashmd_tpu/hub.py; the reference's hub.py:8-83).

Downloads ``model_and_prior.pt`` or a structure file from the Hub; a model
goes through the port's checkpoint reader
(:func:`flashmd_tpu_torch.models.checkpoint_io.load_reference_checkpoint`).
``huggingface_hub`` and network access are optional: each function imports
the package when called, and says what to install when it is absent.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def _hf_hub_download(caller: str):
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise ImportError(
            f"{caller} requires the optional dependency huggingface_hub."
        ) from e
    return hf_hub_download


def from_pretrained(
    repo_id: str = "pingzhili/cg-schnet",
    filename: str = "model_and_prior.pt",
    cache_dir: Optional[str] = None,
    revision: Optional[str] = None,
):
    """Download and read a pre-trained model: a
    :class:`~flashmd_tpu_torch.models.checkpoint_io.ReferenceModel`, bound
    to a molecule by
    :func:`~flashmd_tpu_torch.models.checkpoint_io.build_forcefield`."""
    download = _hf_hub_download("from_pretrained")
    local_path = download(repo_id=repo_id, filename=filename,
                          cache_dir=cache_dir, revision=revision)
    from .models.checkpoint_io import load_reference_checkpoint

    return load_reference_checkpoint(local_path)


def download_file(
    repo_id: str = "pingzhili/cg-schnet",
    filename: str = "1enh_configurations.pt",
    cache_dir: Optional[str] = None,
    revision: Optional[str] = None,
) -> Path:
    """Download a raw file (e.g. starting configurations) from the Hub."""
    download = _hf_hub_download("download_file")
    return Path(download(repo_id=repo_id, filename=filename,
                         cache_dir=cache_dir, revision=revision))
