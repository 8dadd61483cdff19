"""Root pytest hook: build the native WAV library once, before xdist workers.

`voxtpu.native.load()` compiles `voxtpu/native/_wavio.so` with g++ the first
time it is called. Test modules call it when they are imported, and under
xdist every worker imports them at once, so several g++ runs would write the
same file together and a worker could load it half written. Building it here,
in the controlling process, leaves every worker a finished library. Without
g++, `load()` returns None and the native tests skip as they always have.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    from voxtpu import native

    native.load()
