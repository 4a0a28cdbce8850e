"""Host-side data path of the port: transforms, FSC147 and CARPK."""
