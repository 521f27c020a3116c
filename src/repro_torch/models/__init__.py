"""The LM substrate's models: parameters (`params`), building blocks
(`layers`) and assembly with prefill and cached decode (`transformer`)."""
