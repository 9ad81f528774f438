"""Typed command-line option parser shared by compiler and kernel CLIs.

Counterpart of the reference's hand-rolled ``command_line_parser``
(``include/yask_common_api.hpp:334-``, impl ``src/common/common_utils.cpp``):
typed options (bool with ``-no-`` prefix, int, idx-tuple, double, string,
string-list), help formatting, and partial parsing that returns unconsumed
arguments so several option sets can share one command line — the property the
reference relies on to let ``yk_solution::apply_command_line_options`` and the
harness each take their own flags.
"""

from __future__ import annotations

import textwrap
from typing import Any, Callable, Dict, List, Optional, Sequence


from yask_tpu_torch.utils.exceptions import YaskException


class _Option:
    def __init__(self, name: str, help_msg: str, kind: str,
                 target: Callable[[Any], None],
                 current: Callable[[], Any],
                 nargs: int = 1):
        self.name = name
        self.help_msg = help_msg
        self.kind = kind
        self.set = target
        self.current = current
        self.nargs = nargs


class CommandLineParser:
    """Typed option registry + parser.

    Options are registered against setter/getter callables (typically bound to
    attributes of a settings object), mirroring how the reference binds
    options directly to ``KernelSettings``/``CompilerSettings`` fields.
    """

    def __init__(self, width: int = 78):
        self._opts: Dict[str, _Option] = {}
        self._width = width

    # ---- registration ----------------------------------------------------

    def _bind(self, obj, attr):
        def setter(v):
            setattr(obj, attr, v)

        def getter():
            return getattr(obj, attr)
        return setter, getter

    def add_bool_option(self, name: str, help_msg: str, obj, attr: str) -> None:
        """Registers ``-name`` and ``-no-name`` (reference bool-option style)."""
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "bool", setter, getter, 0)

    def add_int_option(self, name: str, help_msg: str, obj, attr: str) -> None:
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "int", setter, getter)

    def add_float_option(self, name: str, help_msg: str, obj, attr: str) -> None:
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "float", setter, getter)

    def add_string_option(self, name: str, help_msg: str, obj, attr: str) -> None:
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "string", setter, getter)

    def add_string_list_option(self, name: str, help_msg: str, obj, attr: str) -> None:
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "strlist", setter, getter)

    def add_idx_option(self, name: str, help_msg: str, obj, attr: str,
                       dims: Optional[Sequence[str]] = None) -> None:
        """An option whose value applies to an IdxTuple attribute.

        Accepts either one value for all dims (``-b 64``) or per-dim options
        generated as ``-name_<dim>`` (``-bx 64`` style in the reference is
        spelled ``-b_x`` here).
        """
        setter, getter = self._bind(obj, attr)
        self._opts[name] = _Option(name, help_msg, "idx_all", setter, getter)
        tup = getter()
        for dim in (dims if dims is not None else tup.get_dim_names()):
            def make(dim_name):
                def dim_setter(v):
                    getter()[dim_name] = v
                return dim_setter
            self._opts[f"{name}_{dim}"] = _Option(
                f"{name}_{dim}", f"{help_msg} (dim '{dim}' only)",
                "int_dim", make(dim), getter)

    # ---- parsing ---------------------------------------------------------

    def parse_args(self, args: Sequence[str]) -> List[str]:
        """Consume recognized options; return leftover args (reference
        ``command_line_parser::parse_args`` contract)."""
        leftover: List[str] = []
        i = 0
        args = list(args)
        while i < len(args):
            arg = args[i]
            name = arg.lstrip("-") if arg.startswith("-") else None
            if name is None:
                leftover.append(arg)
                i += 1
                continue
            # bool negation
            if name.startswith("no-") and name[3:] in self._opts \
                    and self._opts[name[3:]].kind == "bool":
                self._opts[name[3:]].set(False)
                i += 1
                continue
            opt = self._opts.get(name)
            if opt is None:
                leftover.append(arg)
                i += 1
                continue
            if opt.kind == "bool":
                opt.set(True)
                i += 1
                continue
            if i + 1 >= len(args):
                raise YaskException(f"missing value for option -{name}")
            val = args[i + 1]
            try:
                if opt.kind == "int" or opt.kind == "int_dim":
                    opt.set(int(val))
                elif opt.kind == "float":
                    opt.set(float(val))
                elif opt.kind == "string":
                    opt.set(val)
                elif opt.kind == "strlist":
                    opt.set(val.split(","))
                elif opt.kind == "idx_all":
                    tup = opt.current()
                    tup.set_vals_same(int(val))
                else:  # pragma: no cover
                    raise YaskException(f"unknown option kind {opt.kind}")
            except ValueError:
                raise YaskException(
                    f"invalid value '{val}' for option -{name}") from None
            i += 2
        return leftover

    # ---- help ------------------------------------------------------------

    def print_help(self, out=None) -> str:
        lines: List[str] = []
        for name in sorted(self._opts):
            opt = self._opts[name]
            if opt.kind == "int_dim":
                continue  # summarized under the parent idx option
            cur = opt.current()
            flag = f"-[no-]{name}" if opt.kind == "bool" else f"-{name} <val>"
            lines.append(f"  {flag}")
            body = opt.help_msg
            if opt.kind == "idx_all":
                body += (" Also settable per dim via "
                         f"-{name}_<dim> <val>.")
            body += f" Current value = {cur}."
            lines.extend(textwrap.wrap(body, self._width,
                                       initial_indent="      ",
                                       subsequent_indent="      "))
        text = "\n".join(lines) + "\n"
        if out is not None:
            out.write(text)
        return text
