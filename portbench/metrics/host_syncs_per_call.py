"""Calls a call that waited for the device, as PyTorch's sync debug mode
sees them (read-backs such as ``.item()`` and ``.tolist()``), counted by the
benchmark around each call of the traced window."""


def read(rec):
    return None if rec.syncs is None else rec.syncs / rec.calls
