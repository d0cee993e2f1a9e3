"""Client loops, one module a kind of request, found by the ``op`` of a
cell's workload file.  Each defines ``Op(run)`` with ``setup()``,
``client(i, deadline, slice)``, ``close()`` and ``check()``."""
