"""The control-plane line protocol.

Counterpart of ``bfir_tpu/cli/protocol.py`` (JAX-free there; copied with
the port's imports).

Implements the plugin's TCP command set exactly (README.markdown:56-96;
dispatcher connection.cpp:66-672; char-FSM parser command_parser.cpp):

    EQMx <-200..200>   get/set EQ magnitude, band x in 0..30
    EQEN <0|1>         get/set EQ enable
    FnEN <0|1>         get/set file n enable          (n = 1..3)
    EQLV <-200..200>   get/set EQ level
    FnLV <-200..200>   get/set file n level
    FnFN <path | ?>    get/set file n filename ('?' clears; setting probes
                       attenuation and auto-sets the level)
    FnMD               get file n metadata
    DIR <path>         JSON directory listing
    CLOSE              close the connection

Commands are ``OP[ DATA]\\r``; get = empty data returns the value, set
returns ``OK``/``ERR``. All replies are terminated with ``\\r``
(connection.hpp CMD_TERM).

Divergence: the reference's DIR has a Windows drive-letter special case
(PATH_SUB_ROOT, connection.cpp:514-546); on POSIX the filesystem root has no
parent so the case does not arise and is omitted.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

from bfir_tpu_torch.cli.store import ConfigStore

STATUS_OK = "OK"
STATUS_ERROR = "ERR"
FILENAME_NONE = "?"
CMD_TERM = "\r"


def parse_line(line: str) -> Tuple[str, str]:
    """Split ``OP[ DATA]`` (terminator already stripped). The reference FSM
    accepts the first space as the separator; data may contain spaces
    (command_parser.cpp)."""
    line = line.strip("\r\n")
    if " " in line:
        op, data = line.split(" ", 1)
    else:
        op, data = line, ""
    return op.upper(), data


def _parse_int(s: str) -> Optional[int]:
    try:
        return int(s.strip())
    except ValueError:
        return None


def _get_set_int(data: str, getter, setter) -> str:
    if data:
        v = _parse_int(data)
        if v is None:
            return STATUS_ERROR
        setter(v)
        return STATUS_OK
    return str(getter())


def dir_listing(path: str, default_dir: str) -> str:
    """JSON listing: {"dir", "subdir": [{display,name,path}], "file": [...]}
    with a '[..]' parent entry first (connection.cpp:548-648)."""
    p = path or default_dir
    if not os.path.exists(p):
        p = default_dir
    if os.path.isfile(p):
        return json.dumps(p)
    if not os.path.isdir(p):
        raise OSError(f"not a directory: {p}")
    subdirs = []
    files = []
    parent = os.path.dirname(os.path.normpath(p))
    if parent and os.path.exists(parent) and os.path.normpath(p) != parent:
        subdirs.append({"display": "[..]", "name": "..", "path": parent})
    for name in sorted(os.listdir(p)):
        full = os.path.join(p, name)
        entry = {"display": name, "name": name, "path": full}
        if os.path.isdir(full):
            subdirs.append(entry)
        elif os.path.isfile(full):
            files.append(entry)
    return json.dumps({"dir": p, "subdir": subdirs, "file": files}, indent=1)


class CommandHandler:
    """Dispatches parsed commands against a ConfigStore. Returns the reply
    string (without terminator); ``close`` becomes True after CLOSE."""

    def __init__(self, store: ConfigStore, default_dir: Optional[str] = None):
        self.store = store
        self.default_dir = default_dir or os.getcwd()
        self.close = False

    def handle(self, line: str) -> str:
        op, data = parse_line(line)
        s = self.store

        if op.startswith("EQM"):
            band = _parse_int(op[3:])
            if band is None:
                return STATUS_ERROR
            if data:
                v = _parse_int(data)
                if v is None:
                    return STATUS_ERROR
                s.set_eq_mag(band, v)
                return STATUS_OK
            return str(s.get_eq_mag(band))
        if op == "EQEN":
            return _get_set_int(data, s.get_eq_enable, s.set_eq_enable)
        if op == "EQLV":
            return _get_set_int(data, s.get_eq_level, s.set_eq_level)
        if op in ("F1EN", "F2EN", "F3EN"):
            n = int(op[1])
            return _get_set_int(data, lambda: s.get_file_enable(n),
                                lambda v: s.set_file_enable(n, v))
        if op in ("F1LV", "F2LV", "F3LV"):
            n = int(op[1])
            return _get_set_int(data, lambda: s.get_file_level(n),
                                lambda v: s.set_file_level(n, v))
        if op in ("F1FN", "F2FN", "F3FN"):
            n = int(op[1])
            if data:
                if data == FILENAME_NONE:
                    s.clear_file(n)
                    return STATUS_OK
                return STATUS_OK if s.set_file_name(n, data) else STATUS_ERROR
            return s.get_file_name(n)
        if op in ("F1MD", "F2MD", "F3MD"):
            return s.get_file_metadata(int(op[1]))
        if op == "DIR":
            try:
                return dir_listing(data, self.default_dir)
            except OSError:
                return STATUS_ERROR
        if op == "CLOSE":
            self.close = True
            return STATUS_OK
        return STATUS_ERROR
