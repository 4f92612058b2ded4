"""The port's console (cli/console.py) against the JAX package's, case for
case of tests/test_console.py: the multiline-input protocol table of
console_readline and the change-only color emission."""

import io

import pytest

from llama_cpp_q_4_0_tpu.cli import console as jax_console
from llama_cpp_q_4_0_tpu_torch.cli import console as port_console
from llama_cpp_q_4_0_tpu_torch.cli.console import Color, Console

# (stdin text, --multiline-input, the accumulated buffer)
READS = [
    ("hi\n", False, "hi\n"),  # the newline is kept
    ("\n", False, "\n"),  # a bare Enter is length one
    ("a\\\nb\n", False, "a\nb\n"),  # a trailing backslash continues
    ("a\\\nb\\\nc\n", False, "a\nb\nc\n"),
    ("a\nb\\\n", True, "a\nb\n"),  # multiline: plain lines continue, '\' ends
    ("a\nb/\n", True, "a\nb"),  # '/' is dropped and ends
    ("a/\n", False, "a"),
    ("", False, None),  # EOF at once
    ("/\n", False, ""),  # a lone '/' is an empty buffer, not EOF
    ("/\n", True, ""),
    ("abc", False, "abc"),  # Ctrl-D on a non-empty line ends the input
    ("abc", True, "abc"),
    ("a\\\n", False, "a\n"),  # EOF where a continuation was promised
    ("héllo 🌍\\\n你好\n", False, "héllo 🌍\n你好\n"),  # UTF-8 passes through
]


@pytest.mark.parametrize("text,multiline,want", READS)
def test_read_input_matches_jax(text, multiline, want):
    got = Console(use_color=False, multiline_input=multiline).read_input(
        stdin=io.StringIO(text))
    ref = jax_console.Console(use_color=False, multiline_input=multiline).read_input(
        stdin=io.StringIO(text))
    assert got == ref == want


@pytest.mark.parametrize("text,multiline", [(t, m) for t, m, _ in READS])
def test_readline_matches_jax(text, multiline):
    """Each physical line's (text, has_more), in order up to EOF, as JAX
    reads it."""
    def lines(con):
        stdin, out = io.StringIO(text), []
        while True:
            line, more = con.readline(stdin)
            out.append((line, more))
            if line is None:
                return out

    assert (lines(Console(multiline_input=multiline))
            == lines(jax_console.Console(multiline_input=multiline)))


def test_color_change_only_emission():
    out = io.StringIO()
    con = Console(use_color=True)
    con.out = out
    con.set_color(Color.PROMPT)
    con.set_color(Color.PROMPT)  # repeated set: no second write
    con.set_color(Color.DEFAULT)
    assert out.getvalue() == Color.PROMPT.value + Color.DEFAULT.value


def test_color_disabled_writes_nothing():
    out = io.StringIO()
    con = Console(use_color=False)
    con.out = out
    con.set_color(Color.ERROR)
    con.cleanup()
    assert out.getvalue() == ""


def test_colors_are_jax_colors():
    assert {c.name: c.value for c in Color} == {c.name: c.value for c in jax_console.Color}


def test_read_input_colors_match_jax():
    """With color on, read_input writes the same escapes around the input."""
    def written(mod):
        out = io.StringIO()
        con = mod.Console(use_color=True)
        con.out = out
        con.read_input(stdin=io.StringIO("a\\\nb\n"))
        con.cleanup()
        return out.getvalue()

    assert written(port_console) == written(jax_console)


def test_cli_flags_exist():
    from llama_cpp_q_4_0_tpu_torch.cli.main import build_parser

    args = build_parser().parse_args(
        ["-m", "model.bin", "--multiline-input", "--in-prefix", "U: ",
         "--in-suffix", "A: ", "--color"])
    assert args.multiline_input and args.color
    assert args.input_prefix == "U: " and args.input_suffix == "A: "
