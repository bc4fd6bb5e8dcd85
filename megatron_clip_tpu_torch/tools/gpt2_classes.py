"""Write `tokenizer/gpt2_classes.py`: the \\p{L} and \\p{N} classes of
GPT-2's pre-tokenizer as the `tokenizers` package's regex engine has them.

    python -m megatron_clip_tpu_torch.tools.gpt2_classes \\
        megatron_clip_tpu_torch/tokenizer/gpt2_classes.py

Needs the `tokenizers` package (the backend of the JAX package's GPT-2
tokenizer). Every code point c outside the surrogates is put through
`tokenizers.pre_tokenizers.ByteLevel(add_prefix_space=False)` between
letters ("a" c "a"), between digits ("1" c "1") and between punctuation
marks ("!" c "!"): c is a letter where the first stays one piece, a number
where the second does, punctuation or a mark where the third does, and
white space where none does; white space must then be the port's
`_WHITE_SPACE` set. (After a space every class stays one piece, so that
context tells none apart; the tests hold the port's split against the
package's in all four.) The port's pattern
(`tokenizer/megatron_tokenizers.py::gpt2_pattern`) is then built from the
written table, whatever Unicode version the running Python carries.
"""
import argparse
import sys
from typing import Dict, List, Tuple

SURROGATES = range(0xD800, 0xE000)
_CONTEXTS = (("L", "a{}a"), ("N", "1{}1"), ("P", "!{}!"))


def classify(pre_tokenizer) -> Dict[str, List[int]]:
    """{"L": letters, "N": numbers, "P": the rest but white space, "S":
    white space}: every code point but the surrogates, by how
    `pre_tokenizer` splits it in the three contexts."""
    out = {"L": [], "N": [], "P": [], "S": []}
    for c in range(sys.maxunicode + 1):
        if c in SURROGATES:
            continue
        ch = chr(c)
        for cls, ctx in _CONTEXTS:
            if len(pre_tokenizer.pre_tokenize_str(ctx.format(ch))) == 1:
                break
        else:
            cls = "S"
        out[cls].append(c)
    return out


def ranges(points: List[int]) -> List[Tuple[int, int]]:
    """Sorted code points as inclusive (first, last) runs."""
    out = []
    for c in points:
        if out and out[-1][1] == c - 1:
            out[-1] = (out[-1][0], c)
        else:
            out.append((c, c))
    return out


def _rows(name: str, runs: List[Tuple[int, int]]) -> List[str]:
    lines = [f"{name} = ("]
    row = []
    for lo, hi in runs:
        row.append(f"(0x{lo:X}, 0x{hi:X}),")
        if len(" ".join(row)) > 60:
            lines.append("    " + " ".join(row))
            row = []
    if row:
        lines.append("    " + " ".join(row))
    lines.append(")")
    return lines


def render(classes: Dict[str, List[int]], source: str) -> str:
    head = [
        'r"""GPT-2\'s pre-tokenizer classes \\p{L} and \\p{N}, as inclusive',
        "code-point runs, from the regex engine of " + source + ".",
        "",
        "Written by `python -m megatron_clip_tpu_torch.tools.gpt2_classes`;",
        "do not edit. White space is `megatron_tokenizers._WHITE_SPACE`;",
        "every other code point is in neither class.",
        '"""',
        f"SOURCE = {source!r}",
        "",
    ]
    return "\n".join(head + _rows("LETTERS", ranges(classes["L"])) + [""]
                     + _rows("NUMBERS", ranges(classes["N"]))) + "\n"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("output", help="the table module to write")
    args = p.parse_args(argv)
    import tokenizers
    from tokenizers import pre_tokenizers
    from megatron_clip_tpu_torch.tokenizer.megatron_tokenizers import (
        _WHITE_SPACE)
    classes = classify(pre_tokenizers.ByteLevel(add_prefix_space=False))
    if classes["S"] != sorted(_WHITE_SPACE):
        raise RuntimeError("the white space the pre-tokenizer splits on is "
                           "not megatron_tokenizers._WHITE_SPACE: "
                           + ", ".join(f"U+{c:04X}" for c in classes["S"]))
    with open(args.output, "w", encoding="utf-8") as f:
        f.write(render(classes, f"tokenizers {tokenizers.__version__}"))
    print(f"{args.output}: {len(classes['L'])} letters, "
          f"{len(classes['N'])} numbers, {len(classes['S'])} white space")


if __name__ == "__main__":
    main()
