"""Self-managed TLS for the placement service.

The reference self-manages its webhook TLS with a cert-controller
rotator (CA "Grove-CA", regenerated secret, restart-on-refresh —
internal/controller/cert/cert.go). This package's network boundary is the
placement service, so the same machinery lives here: a self-signed CA
signs a server certificate for the service address; rotation is
regeneration (issue_server_cert again), and clients trust the CA bundle.

The counterpart of grove_tpu/service/tls.py (it needs `cryptography`).
"""

from __future__ import annotations

import datetime
import ipaddress
from dataclasses import dataclass

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

CA_NAME = "Grove-CA"  # cert.go:36-70 flavor


def _name(common_name: str) -> x509.Name:
    return x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)]
    )


def _key():
    return ec.generate_private_key(ec.SECP256R1())


def _pem_cert(cert: x509.Certificate) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def _pem_key(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )


@dataclass
class CertBundle:
    """PEM material for one side of the boundary."""

    ca_cert: bytes
    cert: bytes
    key: bytes


def make_ca(valid_days: int = 3650):
    """Self-signed CA (the rotator's 'Grove-CA')."""
    key = _key()
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(CA_NAME))
        .issuer_name(_name(CA_NAME))
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=valid_days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=0),
                       critical=True)
        .sign(key, hashes.SHA256())
    )
    return cert, key


def issue_server_cert(ca_cert, ca_key, hostname: str = "localhost",
                      valid_days: int = 365,
                      extra_sans: tuple[str, ...] = ()) -> CertBundle:
    """CA-signed server certificate; re-issuing IS the rotation. IP hosts
    get IPAddress SANs (gRPC/OpenSSL verifies an IP target against those,
    never DNSName entries); DNS names are deduplicated. extra_sans: the
    names clients actually dial beyond the bind host — e.g. a Kubernetes
    Service DNS name (deploy/placement-service.yaml passes --san) — each
    classified as IP or DNS the same way as the primary hostname."""
    key = _key()
    now = datetime.datetime.now(datetime.timezone.utc)
    ips = set()
    dns = {"localhost"}
    for name in (hostname, *extra_sans):
        try:
            ips.add(ipaddress.ip_address(name))
        except ValueError:
            dns.add(name)
    entries: list = [x509.IPAddress(ip) for ip in sorted(ips, key=str)]
    entries.extend(x509.DNSName(n) for n in sorted(dns))
    san = x509.SubjectAlternativeName(entries)
    cert = (
        x509.CertificateBuilder()
        .subject_name(_name(hostname))
        .issuer_name(ca_cert.subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=valid_days))
        .add_extension(san, critical=False)
        .sign(ca_key, hashes.SHA256())
    )
    return CertBundle(
        ca_cert=_pem_cert(ca_cert), cert=_pem_cert(cert), key=_pem_key(key)
    )


def self_managed_bundle(hostname: str = "localhost") -> CertBundle:
    """One-call bootstrap: fresh CA + server cert (what the reference's
    rotator does on first start)."""
    ca_cert, ca_key = make_ca()
    return issue_server_cert(ca_cert, ca_key, hostname=hostname)


def load_or_create_ca(directory):
    """Persistent CA for a tls-dir (ca.pem + ca-key.pem): reuse when both
    exist so server restarts ROTATE the server cert under the SAME CA and
    existing client trust keeps working; create + persist otherwise."""
    import os
    from pathlib import Path

    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    cert_path, key_path = d / "ca.pem", d / "ca-key.pem"
    if cert_path.exists() and key_path.exists():
        ca_cert = x509.load_pem_x509_certificate(cert_path.read_bytes())
        ca_key = serialization.load_pem_private_key(
            key_path.read_bytes(), password=None
        )
        return ca_cert, ca_key
    ca_cert, ca_key = make_ca()
    # a half-written dir (crash between the two writes, or an operator
    # forcing a new CA by deleting one file) regenerates BOTH files; the
    # key is written FIRST so cert+key existing together implies a
    # persisted key, and it is BORN 0600 (O_EXCL after removing any stale
    # file) — a write-then-chmod leaves a umask-dependent window where a
    # crash persists the CA key readable (advisor r3)
    cert_path.unlink(missing_ok=True)
    key_path.unlink(missing_ok=True)
    fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.write(fd, _pem_key(ca_key))
    finally:
        os.close(fd)
    cert_path.write_bytes(_pem_cert(ca_cert))
    return ca_cert, ca_key


class CertRotator:
    """Expiry-driven server-cert renewal — the reference's cert-controller
    rotator loop (cert.go:36-70: regenerate before expiry, restart on
    refresh). The CA is stable (clients keep trusting ca.pem); the SERVER
    cert is re-issued once `now` enters the renewal window before
    not_valid_after. `now_fn` is injectable so tests drive renewal from a
    virtual clock (OpenSSL itself always sees real time; what the rotator
    controls is WHEN a fresh cert exists)."""

    def __init__(self, ca_cert, ca_key, hostname: str = "localhost",
                 valid_days: int = 365, renew_before_days: float = 30.0,
                 now_fn=None, extra_sans: tuple[str, ...] = ()):
        self.ca_cert = ca_cert
        self.ca_key = ca_key
        self.hostname = hostname
        self.extra_sans = tuple(extra_sans)
        self.valid_days = valid_days
        self.renew_before = datetime.timedelta(days=renew_before_days)
        self._now_fn = now_fn or (
            lambda: datetime.datetime.now(datetime.timezone.utc)
        )
        self.bundle = issue_server_cert(
            ca_cert, ca_key, hostname=hostname, valid_days=valid_days,
            extra_sans=self.extra_sans,
        )
        self.rotations = 0

    @property
    def not_valid_after(self) -> datetime.datetime:
        cert = x509.load_pem_x509_certificate(self.bundle.cert)
        return cert.not_valid_after_utc

    def renewal_due(self) -> bool:
        return self._now_fn() >= self.not_valid_after - self.renew_before

    def maybe_renew(self) -> bool:
        """Re-issue the server cert under the same CA when due. Returns
        True when a fresh bundle was installed."""
        if not self.renewal_due():
            return False
        self.bundle = issue_server_cert(
            self.ca_cert, self.ca_key, hostname=self.hostname,
            valid_days=self.valid_days, extra_sans=self.extra_sans,
        )
        self.rotations += 1
        return True
