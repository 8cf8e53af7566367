"""Read images directly out of zip archives (``archive.zip@inner/path``).

A copy of ``fhpe_tpu/utils/zipreader.py`` (the reference's
``lib/utils/zipreader.py``): zip file handles are cached, and
:func:`imread` decodes an entry through the port's image library
(``ops/native_image.py``) where ``fhpe_tpu`` calls ``cv2.imdecode``; the
rest is pinned to the original by ``tests/test_torch_port_hygiene.py``.

Handles are cached per-THREAD (the reference caches per-process,
``lib/utils/zipreader.py:23-46``, which is fine there because its loader
parallelism is worker *processes*): a ``ZipFile``'s member reads are
serialized on the handle's internal lock, so a shared handle would degrade
the ``BatchLoader`` thread pool to sequential archive reads on a real
multi-core host.  One open handle per (thread, archive) costs a file
descriptor each and removes the lock contention entirely.
"""

from __future__ import annotations

import os
import threading
import zipfile

_local = threading.local()


def split_path(path: str):
    pos = path.index("@")
    zip_path = path[:pos - 1] if path[pos - 1] == os.sep else path[:pos]
    # paths are built like ".../train2017.zip@/name.jpg" (os.path.join adds
    # the separator after '@'); zip entries are archive-relative
    inner = path[pos + 1:].lstrip("/")
    return zip_path, inner


def _get_zip(zip_path: str) -> zipfile.ZipFile:
    cache = getattr(_local, "cache", None)
    if cache is None:
        cache = _local.cache = {}
    zf = cache.get(zip_path)
    if zf is None:
        zf = zipfile.ZipFile(zip_path, "r")
        cache[zip_path] = zf
    return zf


def imread(path: str, bgr: bool = True):
    """A JPEG entry as (H, W, 3) uint8, BGR (or RGB with ``bgr=False``)."""
    from ..ops.native_image import decode_jpeg_bytes

    return decode_jpeg_bytes(read_bytes(path), bgr=bgr, name=path)


def read_bytes(path: str) -> bytes:
    zip_path, inner = split_path(path)
    return _get_zip(zip_path).read(inner)


def xmlread(path: str):
    """Parse an XML file stored inside a zip archive (zipreader.py:49-70)."""
    import xml.etree.ElementTree as ET

    return ET.fromstring(read_bytes(path))
