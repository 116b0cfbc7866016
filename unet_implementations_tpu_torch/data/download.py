"""Dataset acquisition: fetch the raw archive, and extract a local one.

The port's own copy of ``unet_implementations_tpu/data/download.py``. The
reference fetches a Google Drive archive (``Data_filtered.tar``) and untars
it into ``data/raw/``; ``download_archive`` fetches it with the standard
library's urllib. An archive already on disk is extracted without any fetch
(``extract_archive``, or ``download_and_extract`` when the archive exists):
``cli pipeline`` then reads the extracted tree.
"""

from __future__ import annotations

import tarfile
import urllib.request
from pathlib import Path
from typing import Optional

DRIVE_FILE_ID = "1-BMGfI4_XfwDk5SZL6JoDSLxt7rYiAeI"
DRIVE_URL = (
    "https://drive.usercontent.google.com/download?id={id}&export=download&confirm=t"
)


def download_archive(
    output_path: str | Path,
    file_id: str = DRIVE_FILE_ID,
    timeout: int = 60,
) -> Path:
    """Download the dataset tar from Google Drive. Raises on network failure
    (offline environments should place the archive manually)."""
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    url = DRIVE_URL.format(id=file_id)
    print(f"downloading {url} -> {output_path}")
    with urllib.request.urlopen(url, timeout=timeout) as r, open(output_path, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    return output_path


def extract_archive(archive_path: str | Path, raw_dir: str | Path) -> Path:
    """Untar into ``raw_dir`` (the reference extracts into ``data/raw``)."""
    raw_dir = Path(raw_dir)
    raw_dir.mkdir(parents=True, exist_ok=True)
    with tarfile.open(archive_path) as tar:
        tar.extractall(raw_dir, filter="data")
    return raw_dir


def download_and_extract(
    raw_dir: str | Path,
    archive_path: Optional[str | Path] = None,
    file_id: str = DRIVE_FILE_ID,
) -> Path:
    """Extract the archive into ``raw_dir``, downloading it first only when
    it is not on disk (default place: beside ``raw_dir``)."""
    raw_dir = Path(raw_dir)
    archive_path = Path(archive_path or raw_dir.parent / "Data_filtered.tar")
    if not archive_path.exists():
        try:
            download_archive(archive_path, file_id)
        except Exception as e:
            raise RuntimeError(
                f"download failed ({e}); in offline environments place the "
                f"archive at {archive_path} or the extracted tree at {raw_dir}"
            ) from e
    return extract_archive(archive_path, raw_dir)
