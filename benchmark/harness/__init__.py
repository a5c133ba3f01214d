"""The benchmark's harness: it finds a cell's pieces by name, makes the
inputs from the seed, drives the program through the measured window,
reads the trace and decides ``correct`` (see ``benchmark/README.md``)."""
