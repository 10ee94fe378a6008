"""sregex-tpu: a streaming regex engine for accelerators (NVIDIA GPUs).

A from-scratch rebuild of the capabilities of libsregex (jnsquire/sregex)
designed for the device first:

  - host frontend: regex text -> AST -> NFA bytecode (parser.py,
    compiler.py), semantics-equivalent to the reference's bison parser
    and compiler;
  - host engines: streaming Pike VM (captures + multi-regex IDs,
    pike_vm.py) and Thompson VM (thompson_vm.py) — the behavioral
    oracle and small-input path;
  - table compiler: NFA -> DFA over a context-extended byte alphabet
    (dfa.py), the successor of the reference's DynASM x86-64 JIT;
  - device engines: XLA/Pallas DFA scan kernels with resumable
    streaming carry (ops/), sharded over device meshes via
    transfer-function composition (parallel/).

Public API mirrors the reference's C API surface
(/root/reference/src/sregex/sregex.h:82-171).
"""

from .consts import (
    SRE_OK, SRE_ERROR, SRE_AGAIN, SRE_BUSY, SRE_DONE, SRE_DECLINED,
    SRE_REGEX_CASELESS, SRE_REGEX_NEWLINE,
)
from .parser import parse, parse_multi, ParseError
from .compiler import compile_regex
from .pike_vm import PikeCtx, pike_create_ctx
from .thompson_vm import ThompsonCtx, thompson_create_ctx
from .ast_nodes import dump_str as dump_ast
from .bytecode import dump_program
from .stream import compile_pattern, Scanner, StreamScanner, \
    StreamEditor, PreparedCorpus
from .serialize import save_compiled, load_compiled

__version__ = "0.1.0"

__all__ = [
    "SRE_OK", "SRE_ERROR", "SRE_AGAIN", "SRE_BUSY", "SRE_DONE",
    "SRE_DECLINED", "SRE_REGEX_CASELESS", "SRE_REGEX_NEWLINE",
    "parse", "parse_multi", "ParseError", "compile_regex",
    "PikeCtx", "pike_create_ctx", "ThompsonCtx", "thompson_create_ctx",
    "dump_ast", "dump_program",
    "compile_pattern", "Scanner", "StreamScanner", "StreamEditor", "PreparedCorpus",
    "save_compiled", "load_compiled",
]
