"""Interactive console ergonomics for the `main` CLI.

Re-implements the reference's console layer (examples/common.cpp:582-952,
examples/common.h:106-139) behaviorally:

- Four color roles — DEFAULT (reset), PROMPT (yellow), USER_INPUT (bold
  green), ERROR (bold red) — with the same change-only emission
  (console_set_color, common.cpp:645-663): a repeated set_color to the
  current role writes nothing.
- Multiline input protocol (console_readline, common.cpp:852-952): a line
  ending in `\\` continues onto the next line (the backslash is replaced
  by a newline); with --multiline-input the convention is REVERSED — every
  line continues unless it ends in `\\` (which then TERMINATES input) or
  `/` (force-end, the character is dropped).  Ctrl-D / EOF always ends.
- UTF-8 is native: Python 3 strings are unicode, and stdin decoding
  replaces the reference's getchar32/append_utf8 surrogate handling
  (common.cpp:668-718, 816-835).

The reference's raw-termios character echo (put_codepoint cursor-width
bookkeeping, common.cpp:749-806) exists to repaint the trailing special
character in the prompt color while typing; that is display polish only —
the accepted-line semantics here are identical, via cooked-mode lines.
Win32 console handling (common.cpp:584-608) has no analogue: this runtime
is POSIX-only and colors auto-disable when stdout is not a tty.
"""

from __future__ import annotations

import dataclasses
import enum
import sys


class Color(enum.Enum):
    DEFAULT = "\x1b[0m"
    PROMPT = "\x1b[33m"
    USER_INPUT = "\x1b[1m\x1b[32m"
    ERROR = "\x1b[1m\x1b[31m"


@dataclasses.dataclass
class Console:
    """Color + multiline-input state (the console_state analogue,
    common.h:122-133)."""

    use_color: bool = False
    multiline_input: bool = False
    _color: Color = Color.DEFAULT
    out = None  # file-like; defaults to sys.stdout at call time

    def _out(self):
        return self.out if self.out is not None else sys.stdout

    def set_color(self, color: Color) -> None:
        """Change-only ANSI emission (common.cpp:645-663)."""
        if self.use_color and color is not self._color:
            self._out().write(color.value)
            self._color = color
            self._out().flush()

    def cleanup(self) -> None:
        """Reset color on exit (console_cleanup, common.cpp:629-642)."""
        self.set_color(Color.DEFAULT)

    def readline(self, stdin=None) -> tuple[str | None, bool]:
        """Read one physical line; returns (text, has_more).

        `has_more` mirrors console_readline's return (common.cpp:923-950):
        default mode continues only on a trailing `\\`; --multiline-input
        continues by default and a trailing `\\` or `/` ends the input.
        The trailing special character is consumed; `\\`-continuation
        contributes a literal newline to the accumulated text.  EOF
        (Ctrl-D) on an empty read returns (None, False) — distinct from
        a lone `/` line, which yields ("", False) and falls into the
        pass-control-back path like the reference's emptied buffer
        (common.cpp:933-941).  Ctrl-D on a NON-empty line (cooked stdin
        returns text without a trailing newline) is end_of_stream
        (common.cpp:944-947): input ends immediately, no newline
        appended."""
        stdin = stdin if stdin is not None else sys.stdin
        self.set_color(Color.USER_INPUT)
        raw = stdin.readline()
        if raw == "":  # EOF with nothing read
            return None, False
        if not raw.endswith("\n"):  # Ctrl-D mid-line: end_of_stream
            return raw, False
        line = raw[:-1]
        has_more = self.multiline_input
        if line.endswith("\\"):
            line = line[:-1] + "\n"
            has_more = not has_more
        elif line.endswith("/"):
            line = line[:-1]
            has_more = False
        else:
            line += "\n"
        return line, has_more

    def read_input(self, stdin=None) -> str | None:
        """Accumulate readline() until has_more is False (the main.cpp
        buffer loop, main.cpp:603-611).  None on immediate EOF.

        Trailing newlines are KEPT, like the reference buffer: a bare
        Enter yields "\\n" (length 1), which main.cpp:616 treats as
        "pass control back without adding tokens" — callers should test
        len(text) > 1 before tokenizing."""
        parts: list[str] = []
        first = True
        while True:
            line, more = self.readline(stdin)
            if line is None:  # real EOF
                if first:
                    self.set_color(Color.DEFAULT)
                    return None
                break  # EOF mid-accumulation: end input with what we have
            first = False
            parts.append(line)
            if not more:
                break
        self.set_color(Color.DEFAULT)
        return "".join(parts)
