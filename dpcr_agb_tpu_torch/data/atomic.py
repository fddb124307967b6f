"""Atomic file writes for everything the data layer puts under a dataroot
(processed `.npz` samples, `done.flag`, synthetic `.las` plots and label
files), so that several ranks may share one dataroot: each writer fills a
temporary file beside the target and renames it into place, and a reader
sees either no file or a whole one. Processing and generation are
deterministic, so ranks that race write the same content."""
from __future__ import annotations

import contextlib
import os
import threading
from typing import Iterator


def temp_name(path: str) -> str:
    """`<dir>/.<name>.<pid>.<thread id>.tmp`: unique to the writer, hidden,
    and never matched by a reader's `*.npz` or `*.las` glob."""
    head, name = os.path.split(os.fspath(path))
    return os.path.join(
        head, f".{name}.{os.getpid()}.{threading.get_ident()}.tmp")


@contextlib.contextmanager
def atomic_write(path) -> Iterator[str]:
    """Yield a temporary path beside `path` for the caller to write and
    close; on leaving, `os.replace` it onto `path`. When the write or the
    rename fails, the temporary file is removed and the error raised."""
    tmp = temp_name(path)
    if os.path.lexists(tmp):    # left by a dead writer with this pid
        os.unlink(tmp)
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        if os.path.lexists(tmp):
            os.unlink(tmp)
        raise
