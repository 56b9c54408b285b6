"""What every cell shares: finding files by name, the waveforms, the open
loop, the device trace, and the result line."""
