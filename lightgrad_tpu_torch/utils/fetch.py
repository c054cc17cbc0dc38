"""Cached HTTP fetch.

Counterpart of ``lightgrad_tpu/utils/fetch.py``, with its cache: downloads
are kept in a user-owned directory (``~/.cache/lightgrad_tpu``, or
``LIGHTGRAD_CACHE``) under the md5 of their URL, written with an atomic
rename, so the two packages share what either fetched.  A pre-seeded
offline machine drops files named ``md5(url)`` there.
"""

import hashlib
import os

__all__ = ["fetch"]


def _default_cache_dir() -> str:
    d = os.path.join(os.path.expanduser("~"), ".cache", "lightgrad_tpu")
    os.makedirs(d, mode=0o700, exist_ok=True)
    return d


def fetch(url: str) -> bytes:
    cache_dir = os.environ.get("LIGHTGRAD_CACHE") or _default_cache_dir()
    fp = os.path.join(cache_dir, hashlib.md5(url.encode("utf-8")).hexdigest())
    if os.path.isfile(fp) and os.stat(fp).st_size > 0:
        with open(fp, "rb") as f:
            return f.read()
    import urllib.request

    print(f"fetching {url}")
    with urllib.request.urlopen(url, timeout=60) as r:
        dat = r.read()
    with open(fp + ".tmp", "wb") as f:
        f.write(dat)
    os.rename(fp + ".tmp", fp)
    return dat
