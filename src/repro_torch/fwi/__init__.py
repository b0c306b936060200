"""FWI forward engine and its elastic session."""
