"""Training of the LM substrate: AdamW (`optimizer`), the microbatched,
mixed-precision train step (`train_step`), checkpoints in the reference's
on-disk format (`checkpoint`), the fault runtime (`fault`) and int8
gradient compression with error feedback (`compression`). The driver that
puts them together is `repro_torch.launch.train`."""
