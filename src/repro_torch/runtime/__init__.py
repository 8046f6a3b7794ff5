"""The port's training runtime: checkpoints in the reference's on-disk
format, fault-tolerance primitives, and the trainer loop."""
