# A copy of clibd_tpu/utils/table.py, which imports no jax: the port keeps its own copy
# so that it imports nothing of the JAX package.  Keep the two in step.
"""ASCII results table (reference bioscanclip/util/util.py:56-74)."""

from __future__ import annotations

from typing import List, Sequence


class Table:
    def __init__(self, headers: Sequence[str], data: List[Sequence]):
        self.headers = list(headers)
        self.data = [list(row) for row in data]
        cols = list(zip(self.headers, *self.data)) if self.data else [(h,) for h in self.headers]
        self.column_widths = [max(len(str(item)) for item in column) for column in cols]

    def format(self) -> str:
        lines = [self._row(self.headers), self._sep()]
        lines += [self._row(row) for row in self.data]
        return "\n".join(lines)

    def print_table(self) -> None:
        print(self.format())

    def _row(self, row) -> str:
        cells = "|".join(f"{str(item):^{w}}" for item, w in zip(row, self.column_widths))
        return f"|{cells}|"

    def _sep(self) -> str:
        # width + 2 while rows pad to width: reproduces the reference's exact
        # (slightly misaligned) output — print_separator uses width+2 against
        # print_row's :^{width} (util/util.py:68-74)
        return "+" + "+".join("-" * (w + 2) for w in self.column_widths) + "+"
