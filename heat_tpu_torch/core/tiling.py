"""Tile decompositions (heat_tpu ``core/tiling.py``): host metadata over the
original Heat's MPI chunking.

``SplitTiles`` (heat_tpu ``tiling.py:77``) tiles a DNDarray in every
dimension by the process count; ``SquareDiagTiles`` (``:191``) is the
diagonal-aligned 2-D decomposition behind the original Heat's tiled CAQR,
its layout reproduced exactly (quirks included), so tile-addressed code
sees the same ``row_indices``, ``col_indices``, ``tile_map`` and per-process
tile counts. The tile to process assignment is metadata on a virtual
lshape map; the array keeps its canonical ceil-chunk shards.

heat_tpu's documented deviations stay:

- ``get_start_stop`` returns GLOBAL index bounds (the original Heat returns
  bounds into the owner's local tensor).
- ``__getitem__`` returns the tile's data on every rank (the original Heat
  returns ``None`` where the tile is not local). In the port that costs one
  counted :meth:`~TorchCommunication.Bcast` from each rank that holds rows
  of the tile (:func:`_fetch`), none for a replicated array.
  Cross-process tile spans raise ``ValueError``, as in the original Heat.
- The virtual layout uses the original Heat's MPI chunking (remainder over
  the first ranks), so tile boundaries match it bit for bit, while the
  shards are ceil-chunks: the accessors go through global indexing.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .dndarray import DNDarray

__all__ = ["SplitTiles", "SquareDiagTiles"]


def _fetch(arr: DNDarray, slices) -> torch.Tensor:
    """The block ``arr[slices]`` (slices of the global array) on every rank:
    each rank that holds rows of it broadcasts them, one counted
    :meth:`~TorchCommunication.Bcast` each, and every rank concatenates the
    pieces in rank order. A replicated array, or a world of one, reads its
    own tensor."""
    slices = tuple(slice(*s.indices(n)) for s, n in zip(slices, arr.gshape))
    comm = arr.comm
    split = arr.split
    if split is None or comm.size == 1:
        return arr.larray[slices].clone()
    lo, hi = slices[split].start, max(slices[split].stop, slices[split].start)
    counts, displs = comm.counts_displs(arr.gshape[split])
    shape = [s.stop - s.start for s in slices]
    pieces = []
    for r in range(comm.size):
        a, b = max(lo, displs[r]), min(hi, displs[r] + counts[r])
        if a >= b:
            continue
        shape[split] = b - a
        if r == comm.rank:
            local = list(slices)
            local[split] = slice(a - displs[r], b - displs[r])
            buf = arr.larray[tuple(local)].contiguous()
        else:
            buf = torch.empty(shape, dtype=arr.larray.dtype, device=arr.larray.device)
        pieces.append(comm.Bcast(buf, r))
    if not pieces:
        shape[split] = 0
        return torch.empty(shape, dtype=arr.larray.dtype, device=arr.larray.device)
    return torch.cat(pieces, dim=split)


def _mpi_counts(n: int, w: int) -> np.ndarray:
    """Reference MPI chunk sizes of ``n`` items over ``w`` ranks: floor
    division with the remainder spread over the first ranks."""
    base, rem = divmod(int(n), int(w))
    out = np.full(w, base, dtype=np.int64)
    out[:rem] += 1
    return out


def _mpi_piece(n: int, w: int, rank: int) -> int:
    """Size of ``rank``'s chunk (Heat ``comm.chunk`` lshape)."""
    return int(_mpi_counts(n, w)[rank])


def _starts_from_sizes(sizes) -> List[int]:
    """Reference start-index construction (``tiling.py:469-473``):
    ``[0] + sizes[:-1]`` cumulatively summed."""
    return np.concatenate([[0], np.cumsum(np.asarray(sizes, dtype=np.int64))[:-1]]).tolist()


class SplitTiles:
    """Per-process tile map in every dimension (Heat ``tiling.py:14``).

    Every dimension is divided into ``comm.size`` tiles by the original Heat's
    MPI chunking (Heat ``:85-94``) — global-coordinate metadata,
    independent of the physical canonical shards (see module docstring).
    """

    def __init__(self, arr: DNDarray):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        self.__arr = arr
        nprocs = arr.comm.size
        lshape_map = np.asarray(arr.lshape_map)
        # Heat-convention (MPI-chunked) tile grid in every dimension;
        # pure metadata — the physical canonical shards may differ along
        # the split dim, and every accessor goes through global indexing
        tile_dims = np.zeros((arr.ndim, nprocs), dtype=np.int64)
        for ax in range(arr.ndim):
            tile_dims[ax] = _mpi_counts(arr.shape[ax], nprocs)
        self.__tile_dims = tile_dims
        self.__tile_ends_g = np.cumsum(tile_dims, axis=1)
        self.__lshape_map = lshape_map
        # owner of each tile: the process holding its split-dim range
        # (Heat ``set_tile_locations``, ``:108``); split=None means
        # every process holds everything — process 0, as heat_tpu
        locs = np.zeros((nprocs,) * arr.ndim, dtype=np.int64)
        if arr.split is not None:
            shape = [1] * arr.ndim
            shape[arr.split] = nprocs
            locs = locs + np.arange(nprocs).reshape(shape)
        self.__tile_locations = locs

    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def lshape_map(self) -> np.ndarray:
        return self.__lshape_map

    @property
    def tile_ends_g(self) -> np.ndarray:
        """(ndim, nprocs) global end index of every tile (Heat ``:162``)."""
        return self.__tile_ends_g

    @property
    def tile_dimensions(self) -> np.ndarray:
        """(ndim, nprocs) size of every tile (Heat ``:173``)."""
        return self.__tile_dims

    @property
    def tile_ends_per_dim(self) -> List[np.ndarray]:
        """Per-dimension global tile ends as a list (the rows of
        ``tile_ends_g``)."""
        return [self.__tile_ends_g[d] for d in range(self.__arr.ndim)]

    @property
    def tile_locations(self) -> np.ndarray:
        """Owning process of each tile (Heat ``:151``)."""
        return self.__tile_locations

    # ------------------------------------------------------------------ #
    def _key_to_slices(self, key) -> Tuple[slice, ...]:
        if not isinstance(key, tuple):
            key = (key,)
        for k in key:
            if not isinstance(k, (int, np.integer, slice)):
                raise TypeError(f"key type not supported: {type(k)}")
        slices = []
        for dim in range(self.__arr.ndim):
            if dim >= len(key):
                slices.append(slice(None))
                continue
            ends = self.__tile_ends_g[dim]
            starts = np.concatenate([[0], ends[:-1]])
            k = key[dim]
            if isinstance(k, (int, np.integer)):
                slices.append(slice(int(starts[k]), int(ends[k])))
            else:
                if k.step not in (None, 1):
                    raise NotImplementedError(
                        "stepped tile slices are not supported (the skipped "
                        "tiles would be silently included)")
                ks = range(*k.indices(len(ends)))
                if len(ks) == 0:
                    slices.append(slice(0, 0))
                else:
                    slices.append(slice(int(starts[ks[0]]), int(ends[ks[-1]])))
        return tuple(slices)

    def get_tile_size(self, key) -> Tuple[int, ...]:
        """Shape of the tile/s under ``key`` (Heat ``:282``)."""
        return tuple(s.stop - s.start if s.stop is not None
                     else self.__arr.shape[d] - (s.start or 0)
                     for d, s in enumerate(self._key_to_slices(key)))

    def __getitem__(self, key) -> torch.Tensor:
        """The tile's data on every rank (heat_tpu ``tiling.py:169``; the
        original Heat returns the owner's local view and ``None``
        elsewhere): one counted broadcast from each rank that holds rows of
        it, none for a replicated array."""
        return _fetch(self.__arr, self._key_to_slices(key))

    def __setitem__(self, key, value) -> None:
        """Write a tile back (heat_tpu ``tiling.py:176``)."""
        if not isinstance(value, (int, float, complex, np.ndarray,
                                  torch.Tensor, DNDarray, np.number)):
            raise TypeError(f"value type not supported: {type(value)}")
        slices = self._key_to_slices(key)
        self.__arr[slices] = value


class SquareDiagTiles:
    """Diagonal-aligned 2-D tile map (Heat ``tiling.py:331``).

    Reproduces the original Heat's tile layout exactly (see module docstring);
    the per-tile accessors work in global coordinates on the canonical
    layout.
    """

    def __init__(self, arr: DNDarray, tiles_per_proc: int = 2):
        if not isinstance(arr, DNDarray):
            raise TypeError(f"arr must be a DNDarray, got {type(arr)}")
        if isinstance(tiles_per_proc, bool) or not isinstance(
                tiles_per_proc, (int, np.integer)):
            raise TypeError(
                f"tiles_per_proc must be an int, got {type(tiles_per_proc)}")
        if tiles_per_proc < 1:
            raise ValueError(
                f"tiles_per_proc must be >= 1, got {tiles_per_proc}")
        if arr.ndim != 2:
            raise ValueError(
                f"arr must be 2-dimensional, current shape {arr.shape}")
        self.__arr = arr
        size = arr.comm.size
        split = arr.split if arr.split is not None else 0
        m, n = (int(s) for s in arr.shape)

        # virtual lshape map in the original Heat's MPI chunking; layout
        # bookkeeping only — the physical array keeps its canonical shards
        lshape_map = np.zeros((size, 2), dtype=np.int64)
        lshape_map[:, split] = _mpi_counts(arr.shape[split], size)
        lshape_map[:, 1 - split] = arr.shape[1 - split]

        # pre-shift so the diagonal does not end with a sliver on the next
        # process (Heat ``:388-397``; the original Heat redistributes the
        # array, we only move the virtual boundary)
        d = 1 if tiles_per_proc <= 2 else tiles_per_proc - 1
        cums = np.cumsum(lshape_map[:, split])
        redist = np.nonzero(cums >= arr.shape[split - 1] - d)[0]
        if redist.size > 0 and m > n and redist[0] != size - 1:
            lshape_map[redist[0], split] += d
            lshape_map[redist[0] + 1, split] -= d

        row_per_proc_list = [tiles_per_proc] * size

        last_diag_pr, col_per_proc_list, col_inds, tile_columns = (
            self.__create_cols(m, n, split, lshape_map, tiles_per_proc, size))

        if split == 0 and tiles_per_proc == 1:
            # fit the full diagonal on as many processes as possible
            # (Heat ``__adjust_lshape_sp0_1tile``, ``:577``)
            for cnt in col_inds[:-1]:
                for pr in range(size - 1):
                    if lshape_map[pr, 0] < cnt:
                        h = cnt - lshape_map[pr, 0]
                        lshape_map[pr, 0] += h
                        lshape_map[pr + 1, 0] -= h
            negs = np.nonzero(lshape_map[:, 0] < 0)[0]
            for neg in negs:
                lshape_map[neg - 1, 0] += lshape_map[neg, 0]
                lshape_map[neg, 0] = 0
            last_diag_pr, col_per_proc_list, col_inds, tile_columns = (
                self.__create_cols(m, n, split, lshape_map, tiles_per_proc,
                                   size))
            for e in np.nonzero(lshape_map[:, 0] == 0)[0]:
                row_per_proc_list[e] = 0

        row_inds = list(col_inds)

        if split == 0 and m < n:
            # the very last tile column covers the remainder (ref ``:429``)
            col_inds[-1] = n - sum(col_inds[:-1])

        if split == 0 and last_diag_pr < size - 1:
            # diagonal ends before the last process (ref ``:551``)
            lshape_cumsum = np.cumsum(lshape_map[:, 0])
            diff = int(lshape_cumsum[last_diag_pr]) - n
            if diff > lshape_map[last_diag_pr, 0] / 2:
                row_inds.insert(tile_columns, diff)
                row_per_proc_list[last_diag_pr] += 1
            else:
                row_inds[tile_columns - 1] += diff

        if split == 0 and m > n:
            # even tile rows below the diagonal (ref ``:678``)
            for i in range(last_diag_pr + 1, size):
                for t in range(tiles_per_proc):
                    piece = _mpi_piece(lshape_map[i, 0], tiles_per_proc, t)
                    if row_inds[-1] == 0:
                        row_inds[-1] = piece
                    else:
                        row_inds.append(piece)

        if split == 1 and m < n:
            # extend the column list past the diagonal (ref ``:519``;
            # faithfully reproduces the original Heat's quirk of creating
            # column boundaries beyond the array for the trailing procs)
            total_cols = sum(col_per_proc_list)
            r = last_diag_pr + 1
            for _ in range(len(col_inds), total_cols):
                col_inds.append(int(lshape_map[r, 1]))
                r += 1
            # NB: the original Heat computes ``col_proc_ind`` once and does NOT
            # refresh it as inserts shift later indices (``:537-548``) —
            # the layouts below depend on that, so neither do we
            col_proc_ind = np.cumsum(col_per_proc_list)
            for pr in range(size):
                lshape_cumsum = np.cumsum(lshape_map[:, 1])
                col_cumsum = np.cumsum(col_inds)
                diff = int(lshape_cumsum[pr] - col_cumsum[col_proc_ind[pr] - 1])
                if diff > 0 and pr <= last_diag_pr:
                    col_per_proc_list[pr] += 1
                    col_inds.insert(int(col_proc_ind[pr]), diff)
                if pr > last_diag_pr and diff > 0:
                    col_inds.insert(int(col_proc_ind[pr]), diff)

        if split == 1 and m > n:
            # add rows below the diagonal (ref ``:706``)
            if m - n > 10:
                num_ex_row_tiles = 1
                row_inds.append(_mpi_piece(m - n, num_ex_row_tiles, 0))
            else:
                row_inds[-1] = m - sum(row_inds[:-1])

        if m < n:
            row_inds = [r for r in row_inds if r != 0]

        # sizes -> global start indices (ref ``:465-478``)
        col_starts = _starts_from_sizes(col_inds)
        row_starts = _starts_from_sizes(row_inds)
        tile_map = np.zeros((len(row_starts), len(col_starts), 3),
                            dtype=np.int64)
        tile_map[:, :, 0] = np.asarray(row_starts)[:, None]
        tile_map[:, :, 1] = np.asarray(col_starts)[None, :]
        for i in range(size):
            st = sum(row_per_proc_list[:i])
            sp = st + row_per_proc_list[i]
            tile_map[st:sp, :, 2] = i
        tile_map[sum(row_per_proc_list[:size - 1]):, :, 2] = size - 1
        if split == 1:
            st = 0
            for pr, cols in enumerate(col_per_proc_list):
                tile_map[:, st:st + cols, 2] = pr
                st += cols

        self.__lshape_map = lshape_map
        self.__last_diag_pr = int(last_diag_pr)
        self.__tile_map = tile_map
        self.__row_inds = row_starts
        self.__col_inds = col_starts
        self.__row_per_proc_list = (
            row_per_proc_list if split == 0
            else [len(row_starts)] * len(row_per_proc_list))
        self.__col_per_proc_list = (
            col_per_proc_list if split == 1
            else [len(col_starts)] * len(col_per_proc_list))

    @staticmethod
    def __create_cols(m, n, split, lshape_map, tiles_per_proc, size):
        """Diagonal tile columns (Heat ``__create_cols``, ``:608``):
        last diagonal process, per-process tile-column counts, tile-column
        sizes, and the diagonal tile-column count."""
        last_tile_cols = tiles_per_proc
        cums = np.cumsum(lshape_map[:, split])
        last_diag_pr = int(np.nonzero(cums >= min(m, n))[0][0])
        # (the original Heat's small-block while-loop ``:640-646`` is a no-op:
        # ``1 < floor_div < 2`` is unsatisfiable for integers; kept out)
        col_per_proc_list = [tiles_per_proc] * (last_diag_pr + 1)
        col_per_proc_list[-1] = last_tile_cols
        if last_diag_pr < size - 1 and split == 1:
            col_per_proc_list.extend([1] * (size - last_diag_pr - 1))
        tile_columns = tiles_per_proc * last_diag_pr + last_tile_cols
        diag_crossings = cums[:last_diag_pr + 1].tolist()
        diag_crossings[-1] = min(diag_crossings[-1], min(m, n))
        diag_crossings = [0] + diag_crossings
        col_inds = []
        for col in range(tile_columns):
            off = col // tiles_per_proc
            w = tiles_per_proc if off != last_diag_pr else last_tile_cols
            col_inds.append(_mpi_piece(
                diag_crossings[off + 1] - diag_crossings[off], w,
                col % tiles_per_proc))
        return last_diag_pr, col_per_proc_list, col_inds, tile_columns

    # ------------------------------------------------------------------ #
    @property
    def arr(self) -> DNDarray:
        return self.__arr

    @property
    def col_indices(self) -> List[int]:
        """Global start index of every tile column (Heat ``:732``)."""
        return list(self.__col_inds)

    @property
    def row_indices(self) -> List[int]:
        """Global start index of every tile row (Heat ``:754``)."""
        return list(self.__row_inds)

    @property
    def lshape_map(self) -> np.ndarray:
        """The virtual (Heat-convention) local-shape map the tile
        layout was computed from (Heat ``:739``)."""
        return self.__lshape_map

    @property
    def last_diagonal_process(self) -> int:
        """Rank of the last process with diagonal elements (ref ``:747``)."""
        return self.__last_diag_pr

    @property
    def tile_columns(self) -> int:
        return len(self.__col_inds)

    @property
    def tile_rows(self) -> int:
        return len(self.__row_inds)

    @property
    def tile_columns_per_process(self) -> List[int]:
        return list(self.__col_per_proc_list)

    @property
    def tile_rows_per_process(self) -> List[int]:
        return list(self.__row_per_proc_list)

    @property
    def tile_map(self) -> np.ndarray:
        """(tile_rows, tile_columns, 3) array of (row start, col start,
        owning process) per tile (Heat ``:775``)."""
        return self.__tile_map

    # ------------------------------------------------------------------ #
    def _validate_key(self, key) -> None:
        parts = key if isinstance(key, tuple) else (key,)
        if not isinstance(key, (int, np.integer, slice, tuple)):
            raise TypeError(f"key must be int, slice or tuple, got {type(key)}")
        for k in parts:
            if not isinstance(k, (int, np.integer, slice)):
                raise TypeError(f"invalid tile key element: {type(k)}")

    def _key_procs(self, key) -> np.ndarray:
        return np.unique(self.__tile_map[key][..., 2])

    def get_start_stop(self, key) -> Tuple[int, int, int, int]:
        """``(row_start, row_stop, col_start, col_stop)`` of the tile/s
        under ``key`` in GLOBAL indices (Heat ``get_start_stop``,
        ``:824``, returns owner-local bounds; every accessor here works in
        global coordinates, see module docstring). Raises ``ValueError`` when the
        key spans tiles on more than one process, like the original Heat."""
        self._validate_key(key)
        procs = self._key_procs(key)
        if procs.size > 1:
            raise ValueError(
                f"Tile/s must be located on one process, currently on: "
                f"{procs.tolist()}")
        row_inds = self.row_indices + [int(self.__arr.shape[0])]
        col_inds = self.col_indices + [int(self.__arr.shape[1])]
        key = [key] if isinstance(key, (int, np.integer)) else list(key)
        if len(key) == 1:
            key.append(slice(0, None))

        def rng(idx, inds):
            if isinstance(idx, (int, np.integer)):
                return int(inds[idx]), int(inds[idx + 1])
            start = inds[idx.start] if idx.start is not None else 0
            stop = inds[idx.stop] if idx.stop is not None else inds[-1]
            return int(start), int(stop)

        st0, sp0 = rng(key[0], row_inds)
        st1, sp1 = rng(key[1], col_inds)
        return st0, sp0, st1, sp1

    def __getitem__(self, key) -> torch.Tensor:
        """Tile/s contents on every rank (heat_tpu ``tiling.py:484``; the
        original Heat returns the owner's local view and ``None``
        elsewhere), one counted broadcast from each rank that holds rows of
        them. ``ValueError`` on cross-process spans."""
        self._validate_key(key)
        procs = self._key_procs(key)
        if procs.size > 1:
            raise ValueError("Slicing across splits is not allowed")
        r0, r1, c0, c1 = self.get_start_stop(key)
        return _fetch(self.__arr, (slice(r0, r1), slice(c0, c1)))

    def __setitem__(self, key, value) -> None:
        """Write tile/s (Heat ``:1212``)."""
        self._validate_key(key)
        procs = self._key_procs(key)
        if procs.size > 1:
            raise ValueError("setting across splits is not allowed")
        r0, r1, c0, c1 = self.get_start_stop(key)
        self.__arr[r0:r1, c0:c1] = value

    def local_get(self, key) -> torch.Tensor:
        """Tile/s addressed in each rank's own local tile coordinates
        (Heat ``:939``). Every rank takes part in every rank's read, rank by
        rank, and keeps its own."""
        comm = self.__arr.comm
        mine = None
        for r in range(comm.size):
            tile = self[self.local_to_global(key, r)]
            if r == comm.rank:
                mine = tile
        return mine

    def local_set(self, key, value) -> None:
        """Write tile/s addressed in each rank's own local tile coordinates
        with that rank's ``value`` (Heat ``:959``, which writes into the
        local torch view): rank by rank, each rank's value is broadcast
        (one counted broadcast) and written through the global setitem."""
        comm = self.__arr.comm
        if comm.size == 1:
            self[self.local_to_global(key, 0)] = value
            return
        larray = self.__arr.larray
        for r in range(comm.size):
            gkey = self.local_to_global(key, r)
            r0, r1, c0, c1 = self.get_start_stop(gkey)
            if r == comm.rank:
                v = torch.as_tensor(value, dtype=larray.dtype, device=larray.device)
                v = v.expand(r1 - r0, c1 - c0).contiguous()
            else:
                v = torch.empty((r1 - r0, c1 - c0), dtype=larray.dtype, device=larray.device)
            self[gkey] = comm.Bcast(v, r)

    def local_to_global(self, key, rank: int):
        """Local tile coordinates on ``rank`` -> global tile coordinates
        (Heat ``local_to_global``, ``:1022``)."""
        self._validate_key(key)
        key = ([key, slice(0, None)] if isinstance(key, (int, np.integer, slice))
               else list(key))
        split = self.__arr.split
        if split == 0:
            prev = sum(self.__row_per_proc_list[:rank])
            loc = self.__row_per_proc_list[rank]
            if isinstance(key[0], (int, np.integer)):
                key[0] = int(key[0]) + prev
            else:
                start = (key[0].start or 0) + prev
                stop = (key[0].stop + prev if key[0].stop is not None
                        else prev + loc)
                stop = stop if stop - start < loc else start + loc
                key[0] = slice(start, stop)
        if split == 1:
            prev = sum(self.__col_per_proc_list[:rank])
            loc = self.__col_per_proc_list[rank]
            if isinstance(key[1], (int, np.integer)):
                key[1] = int(key[1]) + prev
            else:
                start = (key[1].start or 0) + prev
                stop = (key[1].stop + prev if key[1].stop is not None
                        else prev + loc)
                stop = stop if stop - start < loc else start + loc
                key[1] = slice(start, stop)
        return tuple(key)

    def match_tiles(self, tiles_to_match: "SquareDiagTiles") -> None:
        """Align this map with ``tiles_to_match`` (Heat ``:1084``,
        used to give Q a tile map compatible with A/R's). Metadata-only:
        where the original Heat physically redistributes the arrays, the
        canonical layout stays put and only the virtual maps move."""
        if not isinstance(tiles_to_match, SquareDiagTiles):
            raise TypeError(
                f"tiles_to_match must be SquareDiagTiles, got "
                f"{type(tiles_to_match)}")
        base, match = self.__arr, tiles_to_match.__arr
        size = base.comm.size
        if base.split == 0 and match.split == 0:
            # rows (and cols: square logic) copied from the matched map
            self.__lshape_map = tiles_to_match.lshape_map.copy()
            self.__row_per_proc_list = list(
                tiles_to_match.__row_per_proc_list)
            self.__col_per_proc_list = (
                [tiles_to_match.tile_rows] * len(self.__row_per_proc_list))
            src = (tiles_to_match.__row_inds
                   if base.shape[0] >= base.shape[1]
                   else tiles_to_match.__col_inds)
            self.__row_inds = list(src)
            self.__col_inds = list(src)
            self.__rebuild_tile_map()
        elif base.split == 0 and match.split == 1:
            src = (tiles_to_match.__row_inds
                   if base.shape[0] <= base.shape[1]
                   else tiles_to_match.__col_inds)
            self.__row_inds = list(src)
            self.__col_inds = list(src)
            rows_per = [x for x in self.__col_inds if x < base.shape[0]]
            ldp = tiles_to_match.last_diagonal_process
            target_0 = list(tiles_to_match.lshape_map[:ldp, 1])
            end0 = base.shape[0] - sum(target_0[:ldp])
            target_0 = np.asarray(
                target_0 + [end0] + [0] * (size - 1 - ldp), dtype=np.int64)
            self.__lshape_map = self.__lshape_map.copy()
            self.__lshape_map[:, 0] = target_0
            t0c = np.cumsum(target_0)
            bounds = np.asarray(rows_per + [base.shape[0]])
            self.__row_per_proc_list = []
            st = 0
            for i in range(size):
                self.__row_per_proc_list.append(
                    int(((st < bounds) & (bounds <= t0c[i])).sum()))
                st = t0c[i]
            self.__col_per_proc_list = [self.tile_columns] * size
            self.__last_diag_pr = size - 1
            self.__rebuild_tile_map()
        else:
            raise NotImplementedError(
                "match_tiles supports split combinations (0,0) and (0,1), "
                f"got ({base.split}, {match.split}) — same as the original Heat "
                "(``tiling.py:1108-1210`` implements only these)")

    def __rebuild_tile_map(self) -> None:
        tile_map = np.zeros((self.tile_rows, self.tile_columns, 3),
                            dtype=np.int64)
        tile_map[:, :, 0] = np.asarray(self.__row_inds)[:, None]
        tile_map[:, :, 1] = np.asarray(self.__col_inds)[None, :]
        size = self.__arr.comm.size
        for i in range(size):
            st = sum(self.__row_per_proc_list[:i])
            sp = st + self.__row_per_proc_list[i]
            tile_map[st:sp, :, 2] = i
        tile_map[sum(self.__row_per_proc_list[:size - 1]):, :, 2] = size - 1
        self.__tile_map = tile_map
