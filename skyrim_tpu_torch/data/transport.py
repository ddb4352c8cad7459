"""HTTP(S) transport with byte-range support and retries.

Object stores are reached without boto3/s3fs, through their public
HTTPS endpoints with stdlib urllib (NOAA and ECMWF open-data buckets
are anonymous).  The transport is injectable —
fetchers take a ``transport`` callable so tests substitute a fake
serving synthetic GRIB (the reference's mock-based pattern,
tests/libs/nwp/test_ifs.py:77-104).

The port's copy of skyrim_tpu/data/transport.py.
"""

from __future__ import annotations

import time
import urllib.error
import urllib.request

from skyrim_tpu_torch.utils.logging import logger

USER_AGENT = "skyrim-tpu/0.1"


class TransportError(RuntimeError):
    pass


def http_get(
    url: str,
    offset: int | None = None,
    length: int | None = None,
    retries: int = 3,
    timeout: float = 60.0,
) -> bytes:
    """GET a URL, optionally a byte range [offset, offset+length)."""
    headers = {"User-Agent": USER_AGENT}
    if offset is not None:
        end = "" if length is None else str(offset + length - 1)
        headers["Range"] = f"bytes={offset}-{end}"
    last_err: Exception | None = None
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except (urllib.error.URLError, TimeoutError, ConnectionError) as e:
            last_err = e
            wait = 2.0**attempt
            logger.warning("GET %s failed (%s); retry in %.0fs", url, e, wait)
            time.sleep(wait)
    raise TransportError(f"GET {url} failed after {retries} attempts: {last_err}")


def http_exists(url: str, timeout: float = 30.0) -> bool:
    req = urllib.request.Request(
        url, method="HEAD", headers={"User-Agent": USER_AGENT}
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except Exception:
        return False
