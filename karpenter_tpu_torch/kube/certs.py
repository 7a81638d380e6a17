"""Self-signed serving certificates for the admission webhook.

The reference's webhook process gets its serving certs from knative's
cert-rotation controller (cmd/webhook/main.go:25, SecretName
"karpenter-cert"): a self-signed CA whose bundle is injected into the
webhook configuration so the apiserver can verify the callee. Same story
here: generate_serving_cert() mints a CA plus a CA-signed serving cert for
the webhook's SANs, and the CA bundle travels in the webhook registration
(kube/apiserver.py) for the dispatch-side TLS verification.
"""

from __future__ import annotations

import datetime
import ipaddress
from typing import List, NamedTuple


class ServingCert(NamedTuple):
    ca_pem: bytes
    cert_pem: bytes
    key_pem: bytes


def generate_serving_cert(common_name: str = "karpenter-webhook", sans: List[str] = ("127.0.0.1", "localhost"), days: int = 365) -> ServingCert:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    now = datetime.datetime.now(datetime.timezone.utc)

    def _key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    ca_key = _key()
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, f"{common_name}-ca")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name)
        .issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None), critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    srv_key = _key()
    alt_names = []
    for san in sans:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(san)))
        except ValueError:
            alt_names.append(x509.DNSName(san))
    srv_cert = (
        x509.CertificateBuilder()
        .subject_name(x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)]))
        .issuer_name(ca_name)
        .public_key(srv_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=days))
        .add_extension(x509.SubjectAlternativeName(alt_names), critical=False)
        .sign(ca_key, hashes.SHA256())
    )

    pem = serialization.Encoding.PEM
    return ServingCert(
        ca_pem=ca_cert.public_bytes(pem),
        cert_pem=srv_cert.public_bytes(pem),
        key_pem=srv_key.private_bytes(
            pem, serialization.PrivateFormat.TraditionalOpenSSL, serialization.NoEncryption()
        ),
    )
