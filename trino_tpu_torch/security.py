"""Authentication + authorization (engine-side).

Counterpart of ``trino_tpu/security.py``, the same access controls and
authenticators: the planner consults the catalogs' access control before
it resolves a table, and the runner before a write.

Reference parity: server/security/ (PasswordAuthenticator flow),
plugin/trino-password-authenticators (file-based: username:bcrypt
lines — ours uses salted SHA-256 from hashlib since bcrypt isn't in
the image), security/AccessControlManager.java + the SPI
(spi/security/SystemAccessControl.java, ConnectorAccessControl), and
the file-based access control's catalog/schema/table rules."""

from __future__ import annotations

import hashlib
import hmac
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class AccessDeniedError(Exception):
    """spi/security/AccessDeniedException.java"""

    def __init__(self, what: str):
        super().__init__(f"Access Denied: {what}")


# --------------------------------------------------------------------------
# authentication
# --------------------------------------------------------------------------

class PasswordAuthenticator:
    """spi/security/PasswordAuthenticator — authenticate(user, password)
    -> bool."""

    def authenticate(self, user: str, password: str) -> bool:
        raise NotImplementedError


class InMemoryPasswordAuthenticator(PasswordAuthenticator):
    """Salted-hash store (the file-based authenticator's model,
    plugin/trino-password-authenticators FileAuthenticator)."""

    def __init__(self, users: Optional[Dict[str, str]] = None):
        self._store: Dict[str, Tuple[bytes, bytes]] = {}
        for user, pw in (users or {}).items():
            self.set_password(user, pw)

    @staticmethod
    def _digest(salt: bytes, password: str) -> bytes:
        return hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                   10_000)

    def set_password(self, user: str, password: str) -> None:
        salt = os.urandom(16)
        self._store[user] = (salt, self._digest(salt, password))

    def authenticate(self, user: str, password: str) -> bool:
        entry = self._store.get(user)
        if entry is None:
            return False
        salt, want = entry
        return hmac.compare_digest(want, self._digest(salt, password))


def load_password_file(text: str) -> InMemoryPasswordAuthenticator:
    """'user:password' lines (test/dev convenience; the reference file
    format carries bcrypt digests)."""
    auth = InMemoryPasswordAuthenticator()
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#") and ":" in line:
            user, _, pw = line.partition(":")
            auth.set_password(user, pw)
    return auth


# --------------------------------------------------------------------------
# authorization
# --------------------------------------------------------------------------

class AccessControl:
    """SystemAccessControl SPI surface the engine consults. Default:
    allow everything (AllowAllSystemAccessControl)."""

    def check_can_select(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        pass

    def check_can_create_table(self, user: str, catalog: str,
                               schema: str, table: str) -> None:
        pass

    def check_can_drop_table(self, user: str, catalog: str,
                             schema: str, table: str) -> None:
        pass

    def check_can_insert(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        pass

    def check_can_update(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        # UPDATE/MERGE require the same write privilege as DELETE
        self.check_can_delete(user, catalog, schema, table)

    def check_can_delete(self, user: str, catalog: str, schema: str,
                         table: str) -> None:
        pass

    def check_can_set_session(self, user: str, name: str) -> None:
        pass

    def check_can_kill_query(self, user: str, owner: str) -> None:
        pass


ALLOW_ALL = AccessControl()


@dataclass
class AccessRule:
    """One rule of the file-based access control
    (plugin resource-group-managers style): regexes over
    (user, catalog.schema.table) -> allowed privileges."""
    user: str = ".*"
    table: str = ".*"            # catalog\.schema\.table regex
    privileges: Tuple[str, ...] = ("select", "insert", "delete",
                                   "create", "drop")

    def matches(self, user: str, fqtn: str) -> bool:
        return (re.fullmatch(self.user, user or "") is not None
                and re.fullmatch(self.table, fqtn) is not None)


class RuleBasedAccessControl(AccessControl):
    """First-match-wins rule list (file-based access control
    semantics); no matching rule denies."""

    def __init__(self, rules: List[AccessRule]):
        self.rules = list(rules)

    def _check(self, privilege: str, user: str, catalog: str,
               schema: str, table: str) -> None:
        fqtn = f"{catalog}.{schema}.{table}"
        for rule in self.rules:
            if rule.matches(user, fqtn):
                if privilege in rule.privileges:
                    return
                break
        raise AccessDeniedError(
            f"Cannot {privilege} table {fqtn} as user {user}")

    def check_can_select(self, user, catalog, schema, table):
        self._check("select", user, catalog, schema, table)

    def check_can_create_table(self, user, catalog, schema, table):
        self._check("create", user, catalog, schema, table)

    def check_can_drop_table(self, user, catalog, schema, table):
        self._check("drop", user, catalog, schema, table)

    def check_can_insert(self, user, catalog, schema, table):
        self._check("insert", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table):
        self._check("delete", user, catalog, schema, table)


class GrantBasedAccessControl(AccessControl):
    """Consults the engine-level grant store maintained by GRANT/REVOKE/
    DENY statements (catalog.CatalogManager.grants). Superusers bypass;
    DENY beats GRANT (reference: connector grant semantics +
    io.trino.spi.security.Privilege)."""

    def __init__(self, catalogs, superusers=("admin",)):
        self.catalogs = catalogs
        self.superusers = set(superusers)

    def _check(self, privilege: str, user: str, catalog: str,
               schema: str, table: str) -> None:
        if user in self.superusers:
            return
        key = (user, privilege, catalog, schema, table)
        if key in self.catalogs.denies:
            raise AccessDeniedError(
                f"Cannot {privilege} table "
                f"{catalog}.{schema}.{table} as user {user}")
        if key in self.catalogs.grants:
            return
        raise AccessDeniedError(
            f"Cannot {privilege} table {catalog}.{schema}.{table} "
            f"as user {user}")

    def check_can_select(self, user, catalog, schema, table):
        self._check("select", user, catalog, schema, table)

    def check_can_insert(self, user, catalog, schema, table):
        self._check("insert", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table):
        self._check("delete", user, catalog, schema, table)

    def check_can_update(self, user, catalog, schema, table):
        self._check("update", user, catalog, schema, table)

    def check_can_create_table(self, user, catalog, schema, table):
        if user not in self.superusers:
            raise AccessDeniedError(
                f"Cannot create table {catalog}.{schema}.{table} "
                f"as user {user}")

    def check_can_drop_table(self, user, catalog, schema, table):
        if user not in self.superusers:
            raise AccessDeniedError(
                f"Cannot drop table {catalog}.{schema}.{table} "
                f"as user {user}")


class TokenAuthenticator:
    """Bearer-token authentication (spi: the Authenticator family —
    server/security/jwt/JwtAuthenticator.java).
    ``authenticate_token(token)`` returns the principal or None."""

    def authenticate_token(self, token: str):
        raise NotImplementedError


class JwtAuthenticator(TokenAuthenticator):
    """HS256 JWT validation on a shared secret
    (http-server.authentication.jwt with a symmetric key):
    signature check, ``exp`` enforcement, principal from the
    ``principal_field`` claim (default ``sub``)."""

    def __init__(self, secret: bytes, principal_field: str = "sub",
                 required_audience: Optional[str] = None,
                 required_issuer: Optional[str] = None,
                 require_exp: bool = True):
        self.secret = secret
        self.principal_field = principal_field
        self.required_audience = required_audience
        self.required_issuer = required_issuer
        # a token without exp can never age out, so a leaked one is a
        # permanent credential; reject by default (require_exp=False
        # restores the legacy accept-forever behavior for internal
        # mint-on-boot tokens)
        self.require_exp = require_exp

    @staticmethod
    def _b64url_decode(part: str) -> bytes:
        import base64
        pad = "=" * (-len(part) % 4)
        return base64.urlsafe_b64decode(part + pad)

    @staticmethod
    def _b64url_encode(raw: bytes) -> str:
        import base64
        return base64.urlsafe_b64encode(raw).rstrip(b"=").decode()

    def sign(self, claims: dict) -> str:
        """Mint a token (test harness / internal-node auth helper —
        InternalAuthenticationManager mints its own JWTs the same
        way)."""
        import json as _json
        header = self._b64url_encode(
            _json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        body = self._b64url_encode(_json.dumps(claims).encode())
        signing_input = f"{header}.{body}".encode()
        sig = hmac.new(self.secret, signing_input,
                       hashlib.sha256).digest()
        return f"{header}.{body}.{self._b64url_encode(sig)}"

    def authenticate_token(self, token: str):
        import json as _json
        import time as _time
        try:
            header_b64, body_b64, sig_b64 = token.split(".")
            header = _json.loads(self._b64url_decode(header_b64))
            if header.get("alg") != "HS256":
                return None          # alg confusion is an instant reject
            signing_input = f"{header_b64}.{body_b64}".encode()
            want = hmac.new(self.secret, signing_input,
                            hashlib.sha256).digest()
            if not hmac.compare_digest(want,
                                       self._b64url_decode(sig_b64)):
                return None
            claims = _json.loads(self._b64url_decode(body_b64))
            if not isinstance(claims, dict):
                return None
            exp = claims.get("exp")
            if exp is None:
                if self.require_exp:
                    return None
            elif _time.time() > float(exp):
                return None
            nbf = claims.get("nbf")
            if nbf is not None and _time.time() < float(nbf):
                return None          # not yet valid (RFC 7519 4.1.5)
            if self.required_issuer is not None \
                    and claims.get("iss") != self.required_issuer:
                return None
            if self.required_audience is not None:
                aud = claims.get("aud")
                auds = aud if isinstance(aud, list) else [aud]
                if self.required_audience not in auds:
                    return None
            principal = claims.get(self.principal_field)
            return (principal if isinstance(principal, str)
                    else None)
        except Exception:    # malformed token or odd claim shapes
            return None
