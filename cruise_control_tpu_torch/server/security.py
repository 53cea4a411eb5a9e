"""HTTP security providers (upstream ``servlet/security/*``; SURVEY.md §2.7).

Upstream ships Basic, JWT, SPNEGO/Kerberos and trusted-proxy providers behind
one pluggable interface.  Here the interface is
``authenticate_request(headers, client_address) -> bool``; the server also
accepts the legacy single-header ``authenticate`` signature.  SPNEGO needs a
Kerberos stack the build environment doesn't ship, so that provider is an
explicit unsupported stub rather than a silent no-op.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Dict, Iterable, Optional, Sequence


class SecurityProvider:
    """SPI.  Return True to admit the request."""

    def authenticate_request(self, headers, client_address) -> bool:
        raise NotImplementedError


class BasicSecurityProvider(SecurityProvider):
    """HTTP Basic auth (upstream ``BasicSecurityProvider``)."""

    def __init__(self, users: Dict[str, str]):
        self.users = dict(users)

    def authenticate(self, auth_header: Optional[str]) -> bool:
        if not auth_header or not auth_header.startswith("Basic "):
            return False
        try:
            decoded = base64.b64decode(auth_header[6:]).decode()
            user, _, password = decoded.partition(":")
        except Exception:
            return False
        # constant-time compare; unknown users burn the same comparison so
        # user enumeration by timing stays closed
        expected = self.users.get(user, "")
        return hmac.compare_digest(expected.encode(), password.encode()) \
            and user in self.users

    def authenticate_request(self, headers, client_address) -> bool:
        return self.authenticate(headers.get("Authorization"))


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


class JwtSecurityProvider(SecurityProvider):
    """HS256 bearer-token auth (upstream ``JwtSecurityProvider``): verifies
    the signature, expiry, and (optionally) audience of
    ``Authorization: Bearer <jwt>``."""

    def __init__(self, secret: bytes, audience: Optional[str] = None,
                 time_fn=time.time):
        self.secret = secret if isinstance(secret, bytes) else secret.encode()
        self.audience = audience
        self.time_fn = time_fn

    def authenticate_request(self, headers, client_address) -> bool:
        auth = headers.get("Authorization") or ""
        if not auth.startswith("Bearer "):
            return False
        token = auth[7:].strip()
        try:
            header_b64, payload_b64, sig_b64 = token.split(".")
            header = json.loads(_b64url_decode(header_b64))
            if header.get("alg") != "HS256":
                return False  # only HMAC supported; reject alg confusion
            expected = hmac.new(
                self.secret,
                f"{header_b64}.{payload_b64}".encode(),
                hashlib.sha256,
            ).digest()
            if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
                return False
            payload = json.loads(_b64url_decode(payload_b64))
        except Exception:
            return False
        if "exp" in payload and payload["exp"] < self.time_fn():
            return False
        if self.audience is not None and payload.get("aud") != self.audience:
            return False
        return True

    @staticmethod
    def issue(secret, claims: dict) -> str:
        """Mint an HS256 token (test/ops helper)."""
        secret = secret if isinstance(secret, bytes) else secret.encode()

        def enc(obj) -> str:
            raw = json.dumps(obj, separators=(",", ":")).encode()
            return base64.urlsafe_b64encode(raw).decode().rstrip("=")

        head, body = enc({"alg": "HS256", "typ": "JWT"}), enc(claims)
        sig = hmac.new(secret, f"{head}.{body}".encode(), hashlib.sha256)
        sig_b64 = base64.urlsafe_b64encode(sig.digest()).decode().rstrip("=")
        return f"{head}.{body}.{sig_b64}"


class TrustedProxySecurityProvider(SecurityProvider):
    """Admit requests relayed by a trusted proxy (upstream
    ``TrustedProxySecurityProvider``): the peer address must be allow-listed
    and the proxy must assert the end user via a header."""

    def __init__(self, trusted_ips: Iterable[str],
                 user_header: str = "X-Forwarded-User",
                 allowed_users: Optional[Sequence[str]] = None):
        self.trusted_ips = set(trusted_ips)
        self.user_header = user_header
        self.allowed_users = set(allowed_users) if allowed_users else None

    def authenticate_request(self, headers, client_address) -> bool:
        ip = client_address[0] if client_address else None
        if ip not in self.trusted_ips:
            return False
        user = headers.get(self.user_header)
        if not user:
            return False
        return self.allowed_users is None or user in self.allowed_users


class SpnegoSecurityProvider(SecurityProvider):
    """Upstream supports SPNEGO/Kerberos; this environment has no Kerberos
    stack, so instantiation is allowed (config parity) but authentication
    always fails closed with a clear reason."""

    def __init__(self, *args, **kwargs):
        self.reason = "SPNEGO requires a Kerberos stack (not available)"

    def authenticate_request(self, headers, client_address) -> bool:
        return False
