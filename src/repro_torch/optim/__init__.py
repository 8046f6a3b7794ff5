"""The port's optimizer: AdamW with the reference's schedule, clipping and
numerics, and int8 gradient compression with error feedback."""
