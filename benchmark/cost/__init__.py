"""The benchmark's yardstick: peaks of the chip, and the operations and
bytes of the model and its msda calls, computed from a configuration's
shapes alone (frozen here, so that a change to the program cannot change
what its time is divided into)."""
