#!/usr/bin/env python
"""Render a compiled program's NFA as a graphviz dot graph.

Analog of the reference's util/draw_vm_program.pl (bytecode
dump -> graphviz NFA diagram).

Usage: python util/draw_program.py 'regex' [> out.dot]
       python util/draw_program.py --dfa 'regex'   # render the DFA
"""

import sys
import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sregex_tpu import parse, compile_regex
from sregex_tpu.bytecode import dump_instruction
from sregex_tpu.consts import (OP_CHAR, OP_JMP, OP_SPLIT, OP_MATCH,
                               OP_SAVE, OP_ASSERT, OP_ANY, OP_IN,
                               OP_NOTIN)


def nfa_dot(prog, out):
    out.write("digraph nfa {\n  rankdir=LR;\n  node [shape=box,"
              " fontname=monospace];\n")
    for i, ins in enumerate(prog.insts):
        label = dump_instruction(i, ins).strip().replace('"', '\\"')
        shape = "doublecircle" if ins.opcode == OP_MATCH else "box"
        out.write('  n%d [label="%s", shape=%s];\n' % (i, label, shape))
        if ins.opcode == OP_SPLIT:
            out.write('  n%d -> n%d [label="x"];\n' % (i, ins.x))
            out.write('  n%d -> n%d [label="y", style=dashed];\n'
                      % (i, ins.y))
        elif ins.opcode == OP_JMP:
            out.write("  n%d -> n%d;\n" % (i, ins.x))
        elif ins.opcode != OP_MATCH and i + 1 < len(prog.insts):
            out.write("  n%d -> n%d;\n" % (i, i + 1))
    out.write("}\n")


def dfa_dot(dfa, out):
    out.write("digraph dfa {\n  rankdir=LR;\n  node [shape=circle];\n")
    for s in range(dfa.nstates):
        shape = ("doublecircle" if dfa.match_eof[s] else "circle")
        out.write('  s%d [shape=%s];\n' % (s, shape))
        seen = {}
        for c in range(dfa.nclasses):
            t = int(dfa.trans[s, c])
            m = bool(dfa.match[s, c])
            seen.setdefault((t, m), []).append(c)
        for (t, m), classes in seen.items():
            label = ",".join(map(str, classes))
            style = ', color=red' if m else ''
            out.write('  s%d -> s%d [label="%s"%s];\n'
                      % (s, t, label, style))
    out.write("}\n")


def main():
    args = sys.argv[1:]
    want_dfa = "--dfa" in args
    args = [a for a in args if not a.startswith("--")]
    if not args:
        sys.stderr.write(__doc__)
        return 2
    ast, _ = parse(args[0])
    prog = compile_regex(ast)
    if want_dfa:
        from sregex_tpu.dfa import build_dfa
        dfa_dot(build_dfa(prog), sys.stdout)
    else:
        nfa_dot(prog, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
