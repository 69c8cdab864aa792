"""Sync transport: the wire protocol (`protocol`), the end-to-end
encryption of message contents (`crypto` for OpenPGP, `aead` for the
negotiated `aead-batch-v1` records) and the client transport
(`client.SyncTransport`, `client.connect`).

The names load on first access, so that importing one submodule (the
relay's pre-forked workers import `protocol`) loads no other."""

from evolu_tpu_torch.utils.lazy import lazy_getattr

_LAZY = {
    "EncryptedCrdtMessage": ("evolu_tpu_torch.sync.protocol", "EncryptedCrdtMessage"),
    "SyncRequest": ("evolu_tpu_torch.sync.protocol", "SyncRequest"),
    "SyncResponse": ("evolu_tpu_torch.sync.protocol", "SyncResponse"),
    "decode_sync_request": ("evolu_tpu_torch.sync.protocol", "decode_sync_request"),
    "decode_sync_response": ("evolu_tpu_torch.sync.protocol", "decode_sync_response"),
    "encode_sync_request": ("evolu_tpu_torch.sync.protocol", "encode_sync_request"),
    "encode_sync_response": ("evolu_tpu_torch.sync.protocol", "encode_sync_response"),
    "encrypt_symmetric": ("evolu_tpu_torch.sync.crypto", "encrypt_symmetric"),
    "decrypt_symmetric": ("evolu_tpu_torch.sync.crypto", "decrypt_symmetric"),
    "SyncTransport": ("evolu_tpu_torch.sync.client", "SyncTransport"),
}

__all__ = [
    "EncryptedCrdtMessage",
    "SyncRequest",
    "SyncResponse",
    "decode_sync_request",
    "decode_sync_response",
    "encode_sync_request",
    "encode_sync_response",
    "encrypt_symmetric",
    "decrypt_symmetric",
    "SyncTransport",
]

__getattr__ = lazy_getattr(__name__, _LAZY)
