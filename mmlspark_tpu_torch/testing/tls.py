"""TLS test fixtures: self-signed certificates + client contexts (the
port's copy of ``mmlspark_tpu/testing/tls.py``).

The TLS edge (``docs/serving.md`` "TLS at the edge") needs a
certificate to test against; this module mints a throwaway self-signed
one with the ``openssl`` CLI (no Python crypto dependency — the binary
ships in every base image this repo targets) and builds the matching
client ``SSLContext``. Tests call :func:`tls_supported` and skip when
the interpreter lacks ``ssl`` or the box lacks ``openssl``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Tuple

try:
    import ssl
except ImportError:  # pragma: no cover
    ssl = None  # type: ignore[assignment]

__all__ = ["tls_supported", "generate_self_signed_cert",
           "client_context"]


def tls_supported() -> Tuple[bool, str]:
    """(ok, reason): whether this box can run the TLS edge tests —
    the ``ssl`` module with the modern server protocol AND an
    ``openssl`` binary to mint the self-signed cert."""
    if ssl is None:
        return False, "no ssl module"
    if not hasattr(ssl, "PROTOCOL_TLS_SERVER"):
        return False, "ssl lacks PROTOCOL_TLS_SERVER"
    if shutil.which("openssl") is None:
        return False, "no openssl binary to mint a test cert"
    return True, ""


def generate_self_signed_cert(directory: str,
                              common_name: str = "localhost"
                              ) -> Tuple[str, str]:
    """Mint a throwaway self-signed cert + key under ``directory``;
    returns ``(cert_path, key_path)``. Valid for 127.0.0.1/localhost
    (subjectAltName), 2 days — long enough for any test run, short
    enough that a leaked fixture is worthless."""
    cert = os.path.join(directory, "test-cert.pem")
    key = os.path.join(directory, "test-key.pem")
    cmd = ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
           "-keyout", key, "-out", cert, "-days", "2",
           "-subj", f"/CN={common_name}",
           "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(
            f"openssl could not mint a test cert: {proc.stderr[-400:]}")
    return cert, key


def client_context(cert_path: Optional[str] = None):
    """A client ``SSLContext`` for the test cert: verifies against the
    minted cert when given (hostname checks off — tests dial by IP),
    otherwise trusts anything (the drive-the-edge harness case)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    if cert_path is not None:
        ctx.load_verify_locations(cafile=cert_path)
    else:
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
