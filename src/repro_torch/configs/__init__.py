"""Model configurations of the LM substrate: the schema (`base`) and the
ten published architectures (`registry`)."""
