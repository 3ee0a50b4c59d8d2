"""Checkpoint / resume of session calibration state.

The reference's "checkpoint" is its ini file plus re-capturable calibration
frames (background S(k), π/J0, dark/ref/sample), optionally dumped as raw
.ocv binaries for the offline tool (SURVEY.md §5).  Here the same state —
config + every captured calibration tensor + runtime knobs — round-trips
through one .npz archive, so a session can resume exactly where it stopped.

The port of ``fdoct_tpu/utils/checkpoint.py`` with its npz backend and its
keys, so an archive written by either package loads into the other's
session.  Its orbax backend works only with JAX and is refused here.  One
deliberate deviation: a load also empties the session's ring buffers and
sets their toggle back to its initial value, where the JAX ``load_session``
leaves them as they were (a restored session would otherwise save the frames
of the run before the checkpoint with an 's').
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from fdoct_tpu_torch.utils import to_host

_TENSORS = ("data_yb", "data_yp", "data_yd", "data_yr", "data_ys")
#: cross-group state that may legitimately be absent (a session that never
#: armed J-lockin has no jscansave); written only when present, restored
#: only when stored — old checkpoints load unchanged
_OPT_TENSORS = ("jscansave", "manualaccum")
_SCALARS = ("averagestoggle", "bscanthreshold", "exposure_us",
            "gain", "ascanat", "vertposROI", "widthROI", "indexi",
            "manualindexi")
#: scalars absent from older archives, restored only when stored.  Core
#: _SCALARS stay REQUIRED: a missing scalar_indexi in a damaged archive must
#: fail loudly, not silently resume with defaults and overwrite the previous
#: run's saves.
_OPT_SCALARS = ("averages", "jlockin", "manualaccumcount")


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise ValueError("backend 'orbax' needs JAX (orbax-checkpoint); fdoct_tpu_torch "
                         "writes and reads the 'npz' backend only")
    if backend != "npz":
        raise ValueError(f"unknown backend {backend!r}")


def _payload(session) -> dict:
    payload = {f"tensor_{k}": to_host(getattr(session, k)) for k in _TENSORS}
    for k in _OPT_TENSORS:
        v = getattr(session, k, None)
        if v is not None:
            payload[f"tensor_{k}"] = to_host(v)
    payload.update({f"scalar_{k}": np.asarray(getattr(session, k))
                    for k in _SCALARS + _OPT_SCALARS})
    payload["config_json"] = np.frombuffer(session.cfg.to_json().encode(), dtype=np.uint8)
    return payload


def npz_path(path: str | Path) -> Path:
    """The file np.savez actually writes for ``path`` (numpy appends .npz
    when the suffix is missing) — one place owns that rule so callers
    (e.g. the CLI's atomic periodic checkpoint) never re-encode it."""
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_name(path.name + ".npz")


def save_session(session, path: str | Path, backend: str = "npz") -> Path:
    """Write config + calibration tensors + runtime knobs to ``path`` as one
    compressed archive.  Returns the path actually written (np.savez
    appends .npz when the suffix is missing).  ``backend='orbax'`` raises
    ValueError."""
    _check_backend(backend)
    path = npz_path(path)
    np.savez_compressed(path, **_payload(session))
    return path


def load_session(path: str | Path, session=None, backend: str = "npz",
                 device: torch.device | str = "cuda", **session_kwargs):
    """Rebuild (or update) a Session from a checkpoint.

    With ``session=None`` constructs a fresh Session from the stored config
    on ``device``; otherwise restores tensors/knobs into the given session,
    on its own device (its config must produce the same shapes).  Either
    way the rings are emptied, the ring toggle reset and the current
    accumulation restarted: a checkpoint is group-boundary state.
    ``backend='orbax'``, or a directory (an orbax checkpoint), raises
    ValueError."""
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.session import Session

    _check_backend(backend)
    path = Path(path)
    if path.is_dir():
        raise ValueError(f"{path} is a directory (an orbax checkpoint?); fdoct_tpu_torch "
                         "reads .npz checkpoints only")
    if not path.exists() and npz_path(path).exists():
        path = npz_path(path)   # --checkpoint sess wrote sess.npz
    with np.load(path) as data:
        cfg = PipelineConfig.from_json(bytes(data["config_json"]).decode())
        if session is None:
            session = Session(cfg, device=device, **session_kwargs)
        keys = set(data.files)
        for k in _TENSORS + tuple(k for k in _OPT_TENSORS if f"tensor_{k}" in keys):
            setattr(session, k, torch.as_tensor(data[f"tensor_{k}"]).to(session.device))
        for k in _SCALARS:
            v = data[f"scalar_{k}"][()]   # REQUIRED — loud KeyError if absent
            setattr(session, k, type(getattr(session, k))(v))
        for k in _OPT_SCALARS:
            if f"scalar_{k}" in keys:
                v = data[f"scalar_{k}"][()]
                setattr(session, k, type(getattr(session, k))(v))
    # a restore into a LIVE session mid-group restarts the current
    # accumulation (the semantics of a live 'averages' change,
    # Session.apply_config)
    session.accum = torch.zeros_like(session.accum)
    session.indextemp = 0
    for ring in session._rings.values():
        for part in ring.values():
            part.clear()
    session.zeroisactive = True
    return session
