"""The port's Cartesian topology: the host-level tables copied from the
reference equal it for several grids and periods, and a ``CartComm``
answers its queries — on the world of one of this process, no other
processes needed (the 4-rank exchanges are in
``test_torch_collectives.py``)."""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import errors as jerrors
from repro.core import topology as jtopo
from repro_torch.core import errors, topology
from repro_torch.core.communicator import world
from repro_torch.core.futures import Future, when_all, when_any
from repro_torch.launch.mesh import make_host_communicator

torch.set_num_threads(1)

_GRIDS = [(4,), (2, 3), (3, 1, 2), (1,)]


def _periods(dims):
    return itertools.product((False, True), repeat=len(dims))


@pytest.mark.parametrize("dims", _GRIDS)
def test_cart_tables_equal_the_reference(dims):
    n = int(np.prod(dims))
    for r in range(n):
        assert topology.cart_coords_of(dims, r) == jtopo.cart_coords_of(dims, r)
    for periods in _periods(dims):
        for coords in itertools.product(*[range(-1, d + 1) for d in dims]):
            try:
                want = jtopo.cart_rank_of(dims, periods, coords)
            except jerrors.Error as e:
                with pytest.raises(errors.Error) as ei:
                    topology.cart_rank_of(dims, periods, coords)
                assert ei.value.klass.name == e.klass.name
                continue
            assert topology.cart_rank_of(dims, periods, coords) == want
        for dim in range(len(dims)):
            for disp in (1, -1, 2):
                assert topology.cart_shift_tables(dims, periods, dim, disp) == \
                    jtopo.cart_shift_tables(dims, periods, dim, disp)


def test_cart_shift_record_equals_the_reference():
    assert [f.name for f in dataclasses.fields(topology.CartShift)] == \
        [f.name for f in dataclasses.fields(jtopo.CartShift)]
    assert topology.PROC_NULL == jtopo.PROC_NULL


def test_cart_comm_queries_on_a_world_of_one():
    cart = topology.cart_create(world(device_type="cpu"), (1,), (True,), axis_names=("ring",))
    assert (cart.ndims, cart.dims, cart.periods, cart.size()) == (1, (1,), (True,), 1)
    assert cart.rank() == 0 and cart.coords() == (0,) and cart.cart_coords(0) == (0,)
    assert cart.cart_rank((3,)) == 0  # periodic: wraps
    shift = cart.cart_shift(0, 1)
    assert (shift.sources, shift.destinations, shift.axis_perm) == ((0,), (0,), ((0, 0),))
    x = torch.arange(6.0).reshape(2, 3)
    fut = cart.shift_exchange({"a": x, "b": [x + 1]}, 0, 1)
    got = fut.get()
    assert torch.equal(got["a"], x) and torch.equal(got["b"][0], x + 1)
    assert got["a"].data_ptr() != x.data_ptr()
    line = topology.cart_create(world(device_type="cpu"), (1,), (False,), tag="line-1")
    assert torch.equal(line.shift_exchange(x, 0, 1).get(), torch.zeros_like(x))  # PROC_NULL
    assert line.cart_sub([True]).dims == (1,)


def test_cart_over_one_axis_of_a_grid():
    comm = make_host_communicator(1, 1, device="cpu")
    cart = topology.CartComm(comm, ("model",), dims=(1,), periods=(True,))
    assert cart.axis_names == ("model",) and cart.device == torch.device("cpu")
    with pytest.raises(errors.Error) as ei:
        topology.CartComm(comm, ("model",), dims=(2,), periods=(True,))
    assert ei.value.klass == errors.ErrorClass.ERR_DIMS


def test_when_all_and_when_any():
    a, b = Future(torch.ones(2), works=()), Future(torch.zeros(2), works=())
    got, i = when_any([a, b])
    assert got is a and i == 0
    x, y = when_all([a, b]).get()
    assert torch.equal(x, torch.ones(2)) and torch.equal(y, torch.zeros(2))
    with pytest.raises(errors.Error) as ei:
        when_all([a])
    assert ei.value.klass == errors.ErrorClass.ERR_REQUEST
