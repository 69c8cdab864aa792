"""The sync wire: only what the client worker needs so far."""
