"""Credential/config helpers (copy of skyrim_tpu/utils/env.py).

Loads ``.env`` files (python-dotenv is not installed; the parser here
covers the KEY=VALUE subset the reference's .env.example uses) and
materializes provider config files from environment variables:
``~/.cdsapirc`` for Copernicus and ``~/.ecmwfapirc`` for ECMWF, exactly
as the reference's ``ensure_cds_loaded`` / ``ensure_ecmwf_loaded``.
"""

from __future__ import annotations

import os
from pathlib import Path

from skyrim_tpu_torch.utils.logging import logger


def load_dotenv(path: str | Path = ".env") -> dict[str, str]:
    """Parse KEY=VALUE lines into os.environ (no override of existing)."""
    p = Path(path)
    loaded: dict[str, str] = {}
    if not p.exists():
        return loaded
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key, value = key.strip(), value.strip().strip("'\"")
        loaded[key] = value
        os.environ.setdefault(key, value)
    return loaded


def ensure_cds_loaded(env_path: str | Path = ".env") -> bool:
    """Write ~/.cdsapirc from CDSAPI_URL/CDSAPI_KEY env (or .env)."""
    load_dotenv(env_path)
    key = os.environ.get("CDSAPI_KEY")
    if not key:
        logger.warning("CDSAPI_KEY not set; CDS retrievals will fail")
        return False
    url = os.environ.get("CDSAPI_URL", "https://cds.climate.copernicus.eu/api")
    rc = Path.home() / ".cdsapirc"
    rc.write_text(f"url: {url}\nkey: {key}\n")
    return True


def ensure_ecmwf_loaded(env_path: str | Path = ".env") -> bool:
    """Write ~/.ecmwfapirc from ECMWF_API_* env (or .env)."""
    load_dotenv(env_path)
    key = os.environ.get("ECMWF_API_KEY")
    email = os.environ.get("ECMWF_API_EMAIL")
    if not (key and email):
        return False
    url = os.environ.get("ECMWF_API_URL", "https://api.ecmwf.int/v1")
    rc = Path.home() / ".ecmwfapirc"
    rc.write_text(
        '{\n  "url"   : "%s",\n  "key"   : "%s",\n  "email" : "%s"\n}\n'
        % (url, key, email)
    )
    return True
