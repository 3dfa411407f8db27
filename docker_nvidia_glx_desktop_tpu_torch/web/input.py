"""Input injection: browser events -> the X desktop.

The reference routes web-client input through selkies' data channel into
xdotool/uinput (deps installed at Dockerfile:419-431; joystick via the
LD_PRELOAD interposer, Dockerfile:473-476).  Here:

- wire protocol: compact CSV messages over the WebSocket data channel
  (``parse_message``), covering pointer move/buttons/wheel, keys (X11
  keysyms, as RFB and the browser's ``KeyboardEvent`` map cleanly onto
  them), and clipboard;
- backends: ``XdotoolBackend`` (X present + xdotool installed — the
  container runtime), ``UinputBackend`` (kernel virtual devices through
  /dev/uinput via raw ioctls — no X needed, used for games/pointer-lock),
  ``FakeBackend`` (records events; tests and headless CI).

``make_injector`` picks the best available backend; every consumer (RFB
server, web server) shares one Injector so button state is consistent.
"""

from __future__ import annotations

import fcntl
import logging
import os
import shutil
import struct
import subprocess
import time
from typing import List, Optional

from ..obs import metrics as obsm

log = logging.getLogger(__name__)

_M_PARSE_ERR = obsm.counter(
    "dngd_input_parse_errors_total",
    "Malformed/rejected input-channel messages by reason", ("reason",))

# Log each rejection REASON once per process — a hostile or buggy client
# spraying garbage must cost one counter bump per message, not a log
# line (the counter is the observable; the first line is the diagnosis).
_logged_reasons: set = set()

__all__ = ["InputBackend", "XdotoolBackend", "UinputBackend", "FakeBackend",
           "Injector", "make_injector", "parse_message"]


class InputBackend:
    def move(self, x: int, y: int) -> None: ...
    def move_rel(self, dx: int, dy: int) -> None:
        """Relative pointer motion (the pointer-lock path: games/CAD need
        raw deltas, not absolute positions)."""
    def button(self, button: int, down: bool) -> None: ...
    def wheel(self, dy: int) -> None: ...
    def key(self, keysym: int, down: bool) -> None: ...
    def set_clipboard(self, text: str) -> None: ...
    def get_clipboard(self) -> Optional[str]:
        """Desktop -> client clipboard direction (xclip -o); None when
        unsupported."""
        return None
    def close(self) -> None: ...


class FakeBackend(InputBackend):
    """Records every call — the test double."""

    def __init__(self):
        self.events: List[tuple] = []

    def move(self, x, y):
        self.events.append(("move", x, y))

    def move_rel(self, dx, dy):
        self.events.append(("move_rel", dx, dy))

    def button(self, button, down):
        self.events.append(("button", button, down))

    def wheel(self, dy):
        self.events.append(("wheel", dy))

    def key(self, keysym, down):
        self.events.append(("key", keysym, down))

    def set_clipboard(self, text):
        self.events.append(("clipboard", text))
        self._clipboard = text

    def get_clipboard(self):
        return getattr(self, "_clipboard", None)


class XdotoolBackend(InputBackend):
    """Inject through xdotool (reference Dockerfile:419) — X required."""

    def __init__(self, display: str = ":0"):
        if shutil.which("xdotool") is None:
            raise RuntimeError("xdotool not installed")
        self.env = dict(os.environ, DISPLAY=display)

    def _run(self, *args: str) -> None:
        subprocess.run(["xdotool", *args], env=self.env,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                       timeout=5, check=False)

    def move(self, x, y):
        self._run("mousemove", str(x), str(y))

    def move_rel(self, dx, dy):
        self._run("mousemove_relative", "--", str(dx), str(dy))

    def button(self, button, down):
        self._run("mousedown" if down else "mouseup", str(button))

    def wheel(self, dy):
        self._run("click", "4" if dy > 0 else "5")

    def key(self, keysym, down):
        # xdotool accepts numeric keysyms as 0xNNNN names via `key --`.
        name = f"0x{keysym:04x}"
        self._run("keydown" if down else "keyup", name)

    def set_clipboard(self, text):
        if shutil.which("xclip"):
            p = subprocess.Popen(["xclip", "-selection", "clipboard"],
                                 stdin=subprocess.PIPE, env=self.env)
            p.communicate(text.encode(), timeout=5)

    def get_clipboard(self):
        if shutil.which("xclip") is None:
            return None
        try:
            out = subprocess.run(
                ["xclip", "-selection", "clipboard", "-o"], env=self.env,
                capture_output=True, timeout=5)
            return out.stdout.decode("utf-8", "replace") \
                if out.returncode == 0 else None
        except subprocess.SubprocessError:
            return None


# --- uinput: virtual mouse + keyboard via raw ioctls ------------------------

_UI_SET_EVBIT = 0x40045564
_UI_SET_KEYBIT = 0x40045565
_UI_SET_RELBIT = 0x40045566
_UI_SET_ABSBIT = 0x40045567
_UI_DEV_CREATE = 0x5501
_UI_DEV_DESTROY = 0x5502
_EV_SYN, _EV_KEY, _EV_REL, _EV_ABS = 0x00, 0x01, 0x02, 0x03
_REL_X, _REL_Y, _REL_WHEEL = 0x00, 0x01, 0x08
_ABS_X, _ABS_Y = 0x00, 0x01
_BTN_LEFT, _BTN_RIGHT, _BTN_MIDDLE = 0x110, 0x111, 0x112
_BTN_TOUCH = 0x14A
_ABS_CNT = 64  # ABS_CNT in linux/input.h (sizes the 4 abs arrays)

# Minimal X11 keysym -> Linux KEY_* map (ASCII letters/digits + controls).
_KEYSYM_TO_KEY = {
    0xFF0D: 28, 0xFF1B: 1, 0xFF08: 14, 0xFF09: 15, 0x0020: 57,
    0xFFE1: 42, 0xFFE2: 54, 0xFFE3: 29, 0xFFE4: 97, 0xFFE9: 56, 0xFFEA: 100,
    0xFF51: 105, 0xFF52: 103, 0xFF53: 106, 0xFF54: 108,
    0xFF50: 102, 0xFF57: 107, 0xFF55: 104, 0xFF56: 109, 0xFFFF: 111,
}
for i, ch in enumerate("1234567890"):
    _KEYSYM_TO_KEY[ord(ch)] = 2 + i
for i, ch in enumerate("qwertyuiop"):
    _KEYSYM_TO_KEY[ord(ch)] = 16 + i
    _KEYSYM_TO_KEY[ord(ch.upper())] = 16 + i
for i, ch in enumerate("asdfghjkl"):
    _KEYSYM_TO_KEY[ord(ch)] = 30 + i
    _KEYSYM_TO_KEY[ord(ch.upper())] = 30 + i
for i, ch in enumerate("zxcvbnm"):
    _KEYSYM_TO_KEY[ord(ch)] = 44 + i
    _KEYSYM_TO_KEY[ord(ch.upper())] = 44 + i


class UinputBackend(InputBackend):
    """Kernel-level virtual input device (works with no X server).

    The struct layouts are the stable linux/uinput.h ABI:
    ``struct uinput_user_dev`` (name[80] + id + ff_effects + 4x abs arrays)
    and ``struct input_event`` (timeval + type + code + value).
    """

    def __init__(self, path: str = "/dev/uinput",
                 width: int = 4096, height: int = 4096):
        """``width``/``height``: ABS coordinate range — pointer positions are
        absolute (EV_ABS), so desktop pointer acceleration cannot desync the
        cursor from the client's coordinates (a REL_X/REL_Y design would)."""
        self.fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
        for ev in (_EV_KEY, _EV_REL, _EV_ABS, _EV_SYN):
            fcntl.ioctl(self.fd, _UI_SET_EVBIT, ev)
        for rb in (_REL_X, _REL_Y, _REL_WHEEL):
            fcntl.ioctl(self.fd, _UI_SET_RELBIT, rb)
        for ab in (_ABS_X, _ABS_Y):
            fcntl.ioctl(self.fd, _UI_SET_ABSBIT, ab)
        for code in (_BTN_LEFT, _BTN_RIGHT, _BTN_MIDDLE, _BTN_TOUCH,
                     *set(_KEYSYM_TO_KEY.values())):
            fcntl.ioctl(self.fd, _UI_SET_KEYBIT, code)
        name = b"tpu-desktop-virtual-input"
        dev = struct.pack("80sHHHHi", name.ljust(80, b"\0"),
                          0x03, 0x1234, 0x5678, 1, 0)
        absmax = [0] * _ABS_CNT
        absmax[_ABS_X], absmax[_ABS_Y] = width - 1, height - 1
        dev += struct.pack(f"{_ABS_CNT}i", *absmax)   # absmax
        dev += b"\0" * (_ABS_CNT * 4 * 3)             # absmin/fuzz/flat
        os.write(self.fd, dev)
        fcntl.ioctl(self.fd, _UI_DEV_CREATE)

    def _emit(self, etype: int, code: int, value: int) -> None:
        now = time.time()
        sec, usec = int(now), int((now % 1) * 1e6)
        os.write(self.fd, struct.pack("llHHi", sec, usec, etype, code, value))

    def _syn(self):
        self._emit(_EV_SYN, 0, 0)

    def move(self, x, y):
        self._emit(_EV_ABS, _ABS_X, x)
        self._emit(_EV_ABS, _ABS_Y, y)
        self._syn()

    def move_rel(self, dx, dy):
        if dx:
            self._emit(_EV_REL, _REL_X, dx)
        if dy:
            self._emit(_EV_REL, _REL_Y, dy)
        self._syn()

    def button(self, button, down):
        code = {1: _BTN_LEFT, 2: _BTN_MIDDLE, 3: _BTN_RIGHT}.get(button)
        if code is not None:
            self._emit(_EV_KEY, code, int(down))
            self._syn()

    def wheel(self, dy):
        self._emit(_EV_REL, _REL_WHEEL, 1 if dy > 0 else -1)
        self._syn()

    def key(self, keysym, down):
        code = _KEYSYM_TO_KEY.get(keysym)
        if code is not None:
            self._emit(_EV_KEY, code, int(down))
            self._syn()

    def set_clipboard(self, text):
        pass  # clipboard has no kernel path; X backend handles it

    def close(self):
        try:
            fcntl.ioctl(self.fd, _UI_DEV_DESTROY)
        finally:
            os.close(self.fd)


# --- the injector: protocol -> backend --------------------------------------

# Hardening bounds (the parser feeds an unauthenticated-after-join wire:
# a malformed or hostile message must cost a counter bump, never an
# exception escaping the channel callback or unbounded memory).  The
# whole-message cap IS the data channel's negotiated max-message-size
# (webrtc/sdp.MAX_MESSAGE_SIZE — kept numerically in sync, asserted in
# tests): a clipboard the parser accepts must also be SENDABLE as one
# channel message, so the decoded cap derives from the same budget.
MAX_MESSAGE_CHARS = 262_144           # = sdp.MAX_MESSAGE_SIZE
MAX_CLIPBOARD_B64 = MAX_MESSAGE_CHARS - 8     # minus "c," + slack
MAX_CLIPBOARD_TEXT = MAX_CLIPBOARD_B64 // 4 * 3   # base64 3->4
MAX_FIELD_CHARS = 12                  # numeric fields (int() cost bound)
_COORD_LIMIT = 1 << 16                # sane screen-coordinate envelope


def _reject(reason: str, msg: str) -> None:
    _M_PARSE_ERR.labels(reason).inc()
    if reason not in _logged_reasons:
        _logged_reasons.add(reason)
        log.warning("input message rejected (%s): %.64r "
                    "(logged once per reason; see "
                    "dngd_input_parse_errors_total)", reason, msg)


def _int_field(s: str, limit: int = _COORD_LIMIT) -> int:
    """Bounded numeric field: length-capped before int() and range-
    clamped after (a 1 MB digit string or a 10^30 coordinate is garbage,
    not input)."""
    if len(s) > MAX_FIELD_CHARS:
        raise ValueError("field too long")
    v = int(s)
    if not -limit <= v <= limit:
        raise ValueError("field out of range")
    return v


def parse_message(msg: str) -> Optional[dict]:
    """Parse one data-channel input message; None (counted, log-once)
    on anything malformed, truncated or oversized — this function never
    raises (it sits inside the channel delivery callback).

    Wire format (CSV, first field = op):
      ``m,<x>,<y>``            pointer move (absolute)
      ``mr,<dx>,<dy>``         pointer move (relative; pointer lock)
      ``b,<button>,<0|1>``     pointer button (1=left 2=middle 3=right)
      ``s,<dy>``               scroll wheel
      ``k,<keysym>,<0|1>``     key up/down (X11 keysym, decimal)
      ``c,<base64 text>``      clipboard set (bounded, see
                               MAX_CLIPBOARD_TEXT)
      ``r,<w>x<h>``            resize request (WEBRTC_ENABLE_RESIZE)
      ``kf``                   force keyframe (IDR) request
    """
    try:
        if not isinstance(msg, str):
            _reject("not-text", repr(type(msg)))
            return None
        if len(msg) > MAX_MESSAGE_CHARS:
            _reject("oversized", msg[:64])
            return None
        parts = msg.strip().split(",")
        op = parts[0]
        try:
            if op == "m":
                return {"type": "move", "x": _int_field(parts[1]),
                        "y": _int_field(parts[2])}
            if op == "mr":
                return {"type": "move_rel", "dx": _int_field(parts[1]),
                        "dy": _int_field(parts[2])}
            if op == "b":
                return {"type": "button", "button": _int_field(parts[1]),
                        "down": parts[2] == "1"}
            if op == "s":
                return {"type": "wheel", "dy": _int_field(parts[1])}
            if op == "k":
                # XF86 keysyms reach 0x1008FFFF; 2^31 bounds them all
                return {"type": "key",
                        "keysym": _int_field(parts[1], 1 << 31),
                        "down": parts[2] == "1"}
            if op == "c":
                import base64
                payload = parts[1] if len(parts) > 1 else ""
                if len(payload) > MAX_CLIPBOARD_B64:
                    _reject("clipboard-oversized", msg[:64])
                    return None
                text = base64.b64decode(payload).decode("utf-8",
                                                        "replace")
                if len(text.encode("utf-8")) > MAX_CLIPBOARD_TEXT:
                    _reject("clipboard-oversized", msg[:64])
                    return None
                return {"type": "clipboard", "text": text}
            if op == "r":
                w, h = parts[1].split("x")
                return {"type": "resize", "width": _int_field(w),
                        "height": _int_field(h)}
            if op == "kf":
                return {"type": "keyframe"}
            _reject("unknown-op", msg)
        except (IndexError, ValueError):
            _reject("malformed", msg)
        return None
    except Exception:                 # pragma: no cover - belt & braces
        log.exception("input parser internal error")
        _M_PARSE_ERR.labels("internal").inc()
        return None


class Injector:
    """Routes parsed events into a backend; adapts RFB's stateful masks."""

    def __init__(self, backend: InputBackend):
        self.backend = backend
        self._rfb_buttons = 0

    def handle(self, event: dict) -> None:
        t = event.get("type")
        if t == "move":
            self.backend.move(event["x"], event["y"])
        elif t == "move_rel":
            self.backend.move_rel(event["dx"], event["dy"])
        elif t == "button":
            self.backend.button(event["button"], event["down"])
        elif t == "wheel":
            self.backend.wheel(event["dy"])
        elif t == "key":
            self.backend.key(event["keysym"], event["down"])
        elif t == "clipboard":
            self.backend.set_clipboard(event["text"])

    def handle_message(self, msg: str) -> Optional[dict]:
        event = parse_message(msg)
        if event is not None:
            self.handle(event)
        return event

    def read_clipboard(self) -> Optional[str]:
        """Desktop -> client direction (selkies reads xclip both ways)."""
        return self.backend.get_clipboard()

    def handle_rfb(self, event: dict) -> None:
        """RFB PointerEvent carries a button *mask*; diff it into presses."""
        if event["type"] == "pointer":
            self.backend.move(event["x"], event["y"])
            changed = event["buttons"] ^ self._rfb_buttons
            for bit in range(8):
                if changed & (1 << bit):
                    down = bool(event["buttons"] & (1 << bit))
                    if bit in (3, 4):            # RFB wheel pseudo-buttons
                        if down:
                            self.backend.wheel(1 if bit == 3 else -1)
                    else:
                        self.backend.button(bit + 1, down)
            self._rfb_buttons = event["buttons"]
        elif event["type"] == "key":
            self.backend.key(event["keysym"], event["down"])
        elif event["type"] == "cuttext":
            self.backend.set_clipboard(event["text"])


def make_injector(display: str = ":0") -> Injector:
    """Best available backend: xdotool (X) > uinput (kernel) > fake."""
    try:
        return Injector(XdotoolBackend(display))
    except Exception:
        pass
    try:
        return Injector(UinputBackend())
    except Exception:
        pass
    return Injector(FakeBackend())
