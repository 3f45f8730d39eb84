"""Engine-API JWT auth (reference execution_layer/src/engine_api/auth.rs):
every request to the authenticated engine port carries a short-lived HS256
JWT whose `iat` must be within ±60 s of the server clock, signed with the
32-byte shared secret from the jwt-secret file.

Implemented on stdlib hmac/hashlib/base64 (no external JWT dependency).

The port's copy of lighthouse_tpu/execution_layer/auth.py.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

JWT_SECRET_LEN = 32
# auth.rs: DEFAULT_VALIDITY window for iat drift
JWT_IAT_WINDOW_S = 60


class JwtError(ValueError):
    pass


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def _b64url_decode(data: bytes) -> bytes:
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


class JwtKey:
    """Validated 32-byte HS256 key (auth.rs JwtKey::from_slice)."""

    def __init__(self, secret: bytes):
        if len(secret) != JWT_SECRET_LEN:
            raise JwtError(f"jwt secret must be {JWT_SECRET_LEN} bytes")
        self.secret = bytes(secret)

    @classmethod
    def from_hex(cls, text: str) -> "JwtKey":
        h = text.strip()
        if h.startswith("0x"):
            h = h[2:]
        try:
            return cls(bytes.fromhex(h))
        except ValueError as e:
            raise JwtError(f"bad jwt secret hex: {e}") from None

    @classmethod
    def from_file(cls, path: str) -> "JwtKey":
        with open(path) as f:
            return cls.from_hex(f.read())

    @classmethod
    def random(cls) -> "JwtKey":
        return cls(os.urandom(JWT_SECRET_LEN))

    def to_hex(self) -> str:
        return "0x" + self.secret.hex()


def generate_token(key: JwtKey, now: float | None = None) -> str:
    """Fresh token with an `iat` claim (auth.rs Auth::generate_token)."""
    header = _b64url(json.dumps({"typ": "JWT", "alg": "HS256"}).encode())
    claims = _b64url(
        # lint: allow[wallclock] -- JWT iat is wall time by protocol; the
        # `now` parameter is the injected/testable path
        json.dumps({"iat": int(now if now is not None else time.time())}).encode()
    )
    signing_input = header + b"." + claims
    sig = hmac.new(key.secret, signing_input, hashlib.sha256).digest()
    return (signing_input + b"." + _b64url(sig)).decode()


def validate_token(key: JwtKey, token: str, now: float | None = None) -> dict:
    """Server-side check: signature + iat drift window. Returns the claims
    (the in-process engine rig uses this exactly as geth's auth layer
    would)."""
    parts = token.encode().split(b".")
    if len(parts) != 3:
        raise JwtError("malformed token")
    header_b, claims_b, sig_b = parts
    expected = hmac.new(
        key.secret, header_b + b"." + claims_b, hashlib.sha256
    ).digest()
    if not hmac.compare_digest(expected, _b64url_decode(sig_b)):
        raise JwtError("bad signature")
    try:
        header = json.loads(_b64url_decode(header_b))
        claims = json.loads(_b64url_decode(claims_b))
    except (ValueError, UnicodeDecodeError) as e:
        raise JwtError(f"undecodable token: {e}") from None
    if header.get("alg") != "HS256":
        raise JwtError(f"unsupported alg {header.get('alg')!r}")
    iat = claims.get("iat")
    if not isinstance(iat, int):
        raise JwtError("missing iat claim")
    # lint: allow[wallclock] -- iat drift check against real time, as geth does
    t = now if now is not None else time.time()
    if abs(t - iat) > JWT_IAT_WINDOW_S:
        raise JwtError("stale token (iat outside the validity window)")
    return claims
