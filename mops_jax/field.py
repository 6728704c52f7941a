"""Field binding: mesh + front (+ optional back) solution.

Mirrors the reference MPASOField (src/Core/MPASOField.{h,cpp}): bind the
active solutions and provide host-side particle->cell assignment and the
point-on-ocean test.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .cellsearch import CellSearch
from .mesh import MPASMesh
from .solution import SolutionFields


@dataclasses.dataclass
class Field:
    mesh: MPASMesh
    front: SolutionFields
    back: Optional[SolutionFields] = None
    _search: Optional[CellSearch] = dataclasses.field(default=None, repr=False)

    _device: Optional[tuple] = dataclasses.field(default=None, repr=False)

    @property
    def search(self) -> CellSearch:
        if self._search is None:
            self._search = CellSearch(self.mesh)
        return self._search

    def device_tables(self):
        """(mesh, front) as device-resident jnp arrays, memoized.

        The remap paths are called repeatedly on the same field; numpy-backed
        tables would be re-uploaded to the device on every jitted call."""
        if self._device is None:
            import jax
            import jax.numpy as jnp
            self._device = (jax.tree.map(jnp.asarray, self.mesh),
                            jax.tree.map(jnp.asarray, self.front))
        return self._device

    def calc_in_which_cells(self, points: np.ndarray) -> np.ndarray:
        """Nearest-cell-center assignment (reference
        MPASOField::calcInWhichCells, src/Core/MPASOField.cpp:23-34)."""
        return self.search.query(points)

    def is_on_land(self, point: np.ndarray) -> bool:
        """Edge-normal sign-consistency test at the nearest cell (reference
        MPASOField::isOnOcean, src/Core/MPASOField.cpp:36-81 -- which, despite
        its name, returns true when the point is ON LAND)."""
        import jax.numpy as jnp
        from .remap import _is_land_sign_test
        p = np.asarray(point, dtype=np.float64).reshape(1, 3)
        cell = self.search.query(p)
        return bool(np.asarray(_is_land_sign_test(
            self.mesh, jnp.asarray(p), jnp.asarray(cell)))[0])
