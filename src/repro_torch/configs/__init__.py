"""Model configurations of the LM substrate: the schema (`base`), the ten
published architectures (`registry`, and one module per architecture with
its ``CONFIG`` and reduced ``SMOKE``), and the shape grid (`shapes`)."""
