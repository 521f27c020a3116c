"""Training of the LM substrate: AdamW (`optimizer`) and the microbatched,
mixed-precision train step (`train_step`)."""
