"""Sync transport: the wire protocol (`protocol`), the end-to-end
encryption of message contents (`crypto` for OpenPGP, `aead` for the
negotiated `aead-batch-v1` records) and the client transport
(`client.SyncTransport`, `client.connect`)."""
