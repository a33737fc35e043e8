"""Model layer: DualAR LM, DAC codec decode, tokenizer, prompt assembly."""
