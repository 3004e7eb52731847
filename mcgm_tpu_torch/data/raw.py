"""Raw dataset files the user has placed on disk: check and unpack them.

Port of ``mcgm_tpu/data/download.py`` (``check_md5``, ``_safe_zip_members``,
``extract_file``, ``ensure_raw``) without its downloader: this package
fetches nothing. Each dataset's files are expected under
``{data_dir}/{name}/raw/`` with the names of their public URLs; a missing
file raises ``FileNotFoundError`` naming the path to put it at, the URL it
is published at and its md5, and a file whose md5 differs raises
``ValueError``.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import shutil
import tarfile
import zipfile


def check_md5(path: str, md5: str | None, chunk: int = 1 << 20) -> bool:
    """True if the file at ``path`` has the md5 ``md5`` (any file, if
    ``md5`` is None)."""
    if md5 is None:
        return os.path.exists(path)
    h = hashlib.md5()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest() == md5


def _safe_zip_members(z: zipfile.ZipFile, dest: str):
    """The members of ``z`` that land inside ``dest`` (no ``../``, no
    absolute paths): archives without a published md5 (COIL100's) are
    unpacked unchecked."""
    base = os.path.realpath(dest)
    for m in z.infolist():
        target = os.path.realpath(os.path.join(dest, m.filename))
        if target == base or target.startswith(base + os.sep):
            yield m


def extract_file(path: str, dest: str | None = None) -> None:
    """Unpack a zip, a tar (gz / bz2 / xz) or a plain ``.gz`` into ``dest``
    (the archive's folder by default); members that would land outside it
    are skipped (tar: its ``data`` filter). Any other file is left as it is."""
    dest = dest or os.path.dirname(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            z.extractall(dest, members=list(_safe_zip_members(z, dest)))
    elif tarfile.is_tarfile(path):
        with tarfile.open(path) as t:
            t.extractall(dest, filter="data")
    elif path.endswith(".gz"):
        with gzip.open(path, "rb") as f, open(os.path.join(dest, os.path.basename(path)[:-3]),
                                              "wb") as g:
            shutil.copyfileobj(f, g)


def ensure_raw(files: list[tuple[str, str | None]], raw_folder: str,
               unpacked: str | None = None) -> None:
    """Check and unpack each ``(url, md5)`` of ``files``, which must lie in
    ``raw_folder`` under the URL's file name (an md5 of None is not
    checked). ``unpacked``: the folder the archives unpack to, named in the
    error as the other thing the user may place."""
    for url, md5 in files:
        path = os.path.join(raw_folder, os.path.basename(url))
        if not os.path.exists(path):
            hint = f"; or place its unpacked contents at {unpacked}" if unpacked else ""
            raise FileNotFoundError(
                f"{path} is missing: this package downloads nothing. Place the file published "
                f"at {url} (md5 {md5 or 'not published'}) there{hint}")
        if not check_md5(path, md5):
            raise ValueError(f"{path}: md5 differs from the published {md5} ({url})")
        extract_file(path)
