"""Lock factories of the port (``witness.py``); the static passes that
check them live in ``repro.analysis.concurrency`` and lint ``src/`` as a
whole, the port included."""
